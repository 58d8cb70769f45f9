"""The port's priors and photometric-path loss terms
(``pdfnet_tpu_torch.train.priors``) and the MANO helpers the photometric
loss uses (``axis_to_pca``, ``vertex_normals``) against the JAX package's,
on seeded numpy inputs in float32.

Tolerances: ``pose_limits`` equal bit for bit (the same table, the same
float64 degree-to-radian product rounded to float32); the per-sample terms
within 1e-6 relative (float32 sums over a few hundred to a few thousand
elements in another order); ``hard_example_mining`` within 1e-6 relative,
its ``k = max(int(B * 0.7), 1)`` checked at batches 1 to 10 with ties;
``axis_to_pca`` within 1e-5 of scale (a 45x45 inverse, LAPACK against
XLA's); ``vertex_normals`` within 1e-5 (scatter-added face normals in
another order, then normalized).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.mano import layer as jax_mano
from pdfnet_tpu.train import priors as jax_priors

from pdfnet_tpu_torch import assets
from pdfnet_tpu_torch.mano import layer as mano
from pdfnet_tpu_torch.train import priors

REL = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("table", ["left", "right", "h2o_left", "h2o_right",
                                   "unknown"])
def test_pose_limits(table):
    lo, hi = priors.pose_limits(table)
    jlo, jhi = jax_priors.pose_limits(table)
    assert lo.shape == (45,) and lo.dtype == torch.float32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("dataset", ["H2O", "InterHand"])
def test_pose_shape_prior_loss(dataset):
    rng = np.random.RandomState(0)
    pose_l, pose_r = rng.randn(2, 4, 45).astype(np.float32)
    shape_l, shape_r = rng.randn(2, 4, 10).astype(np.float32)
    got = priors.pose_shape_prior_loss(_t(pose_l), _t(pose_r), _t(shape_l),
                                       _t(shape_r), dataset)
    ref = jax_priors.pose_shape_prior_loss(pose_l, pose_r, shape_l, shape_r,
                                           dataset)
    assert got.shape == (4,) and (got > 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **REL)


def test_photometric_and_silhouette_loss():
    rng = np.random.RandomState(1)
    rendered, image = rng.rand(2, 3, 24, 20, 3).astype(np.float32)
    mask = (rng.rand(3, 24, 20) > 0.5).astype(np.float32)
    mask[2] = 0.0                              # an empty mask: denominator 3
    got = priors.photometric_loss(_t(rendered), _t(image), _t(mask))
    ref = jax_priors.photometric_loss(rendered, image, mask)
    assert got.shape == (3,) and got[2] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **REL)
    soft = rng.rand(3, 24, 20).astype(np.float32)
    np.testing.assert_allclose(
        priors.silhouette_loss(_t(soft), _t(mask)).numpy(),
        np.asarray(jax_priors.silhouette_loss(soft, mask)), **REL)


@pytest.mark.parametrize("shape", [(24, 20, 3), (2, 24, 20, 3)])
def test_psnr(shape):
    """The JAX normalization, ``mean * shape[0] * shape[1] / area``, on a
    single image and on a batch (where it scales by B * H)."""
    rng = np.random.RandomState(2)
    a, b = (rng.rand(2, *shape) * 255).astype(np.float32)
    mask = (rng.rand(*shape[:-1]) > 0.3).astype(np.float32)
    got = priors.psnr(_t(a), _t(b), _t(mask))
    ref = jax_priors.psnr(a, b, mask)
    np.testing.assert_allclose(float(got), float(ref), **REL)


@pytest.mark.parametrize("B", list(range(1, 11)))
def test_hard_example_mining(B):
    rng = np.random.RandomState(B)
    loss = rng.randint(0, 4, B).astype(np.float32)      # ties on purpose
    got = priors.hard_example_mining(_t(loss), 0.7)
    ref = jax_priors.hard_example_mining(jnp.asarray(loss), 0.7)
    k = max(int(B * 0.7), 1)
    assert float(got) == pytest.approx(np.sort(loss)[::-1][:k].mean())
    np.testing.assert_allclose(float(got), float(ref), **REL)


def test_axis_to_pca():
    for side in ("left", "right"):
        consts = mano.load_mano_consts(side, device="cpu")
        jconsts = jax_mano.load_mano_consts(side)
        axis = np.random.RandomState(3).randn(4, 45).astype(np.float32)
        got = mano.axis_to_pca(consts, _t(axis))
        ref = np.asarray(jax_mano.axis_to_pca(jconsts, jnp.asarray(axis)))
        assert got.shape == (4, 45)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(), rtol=0)
        # and back: pca_to_axis inverts it
        np.testing.assert_allclose(mano.pca_to_axis(consts, got).numpy(),
                                   axis, atol=1e-4, rtol=0)


def test_vertex_normals():
    """On the MANO template with 1 mm of noise (a hand's face areas), as
    in the photometric loss."""
    m = assets.load_mano("right")
    rng = np.random.RandomState(4)
    verts = (m.v_template[None] + rng.randn(2, 778, 3) * 1e-3).astype(
        np.float32)
    got = mano.vertex_normals(_t(verts), torch.from_numpy(
        np.asarray(m.faces, np.int64)))
    ref = np.asarray(jax_mano.vertex_normals(jnp.asarray(verts), m.faces))
    assert got.shape == (2, 778, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # unit length, but for the 1e-8 added to the norm (~1e-4 of a norm of
    # summed face areas at this scale)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-3)
