"""The port's tensor ops against the JAX package's on seeded numpy inputs,
and against the torch reference's recorded goldens.

Gathers, NMS and index decoding must agree exactly; float32 arithmetic
within ``atol=rtol=1e-6`` (the same operations, at most a rounding apart),
and the products (resize, projections, Chebyshev basis) within 1e-5, since
the two frameworks sum them in another order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.ops import chebconv as jcheb
from pdfnet_tpu.ops import gather as jgather
from pdfnet_tpu.ops import geometry as jgeo
from pdfnet_tpu.ops import heatmap as jheat
from pdfnet_tpu.ops import resize as jresize

from pdfnet_tpu_torch.ops import chebconv, gather, geometry, heatmap, resize
from test_torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
EXACT = dict(atol=0, rtol=0)
ELEM = dict(atol=1e-6, rtol=1e-6)
PROD = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_gather_pixels_2d():
    rng = np.random.RandomState(0)
    fmap = rng.randn(2, 12, 10, 5).astype(np.float32)
    ind = rng.randint(0, 120, (2, 7)).astype(np.int32)
    ref = jgather.gather_pixels_2d(jnp.asarray(fmap), jnp.asarray(ind))
    got = gather.gather_pixels_2d(_t(fmap), _t(ind))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)


@pytest.mark.parametrize("size", [3, 5])
def test_gather_patches_at_borders(size):
    rng = np.random.RandomState(1)
    fmap = rng.randn(2, 9, 11, 4).astype(np.float32)
    # corners, edges and the interior
    ind = np.array([[0, 10, 98, 60], [88, 45, 11, 21]], np.int32)
    ref = jgather.gather_patches(jnp.asarray(fmap), jnp.asarray(ind), size)
    got = gather.gather_patches(_t(fmap), _t(ind), size)
    assert got.shape == (2, 4, size, size, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)


@pytest.mark.parametrize("shape,out", [((2, 3, 3, 4), (6, 6)),
                                       ((1, 12, 7, 2), (48, 28)),
                                       ((1, 1, 5, 3), (2, 10))])
def test_resize_bilinear_align_corners(shape, out):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = jresize.resize_bilinear_align_corners(jnp.asarray(x), *out)
    got = resize.resize_bilinear_align_corners(_t(x), *out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PROD)
    # align_corners=True semantics: torch's own interpolate agrees
    want = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=out, mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PROD)


def test_upsample2x_nearest():
    x = np.random.RandomState(3).randn(2, 5, 3).astype(np.float32)
    ref = jresize.upsample2x_nearest(jnp.asarray(x), axis=1)
    got = resize.upsample2x_nearest(_t(x), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)


def test_clamped_sigmoid():
    x = np.random.RandomState(4).randn(3, 8, 8, 2).astype(np.float32) * 12
    ref = jheat.clamped_sigmoid(jnp.asarray(x))
    got = heatmap.clamped_sigmoid(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ELEM)


def test_heatmap_nms_and_decode():
    """NMS with -inf padding and first-index argmax, on maps with planted
    plateaus (equal neighbours) and negative values at the border."""
    rng = np.random.RandomState(5)
    hm = rng.uniform(-1, 1, (3, 16, 16, 2)).astype(np.float32)
    hm[0, 4, 4:7, 0] = 2.0             # a plateau: all three survive NMS
    hm[1, 0, 0, 1] = -0.5              # negative corner, -inf padded
    hm[2] = -1.0                       # constant map: first index wins
    ref_nms = jheat.heatmap_nms(jnp.asarray(hm))
    got_nms = heatmap.heatmap_nms(_t(hm))
    np.testing.assert_allclose(got_nms.numpy(), np.asarray(ref_nms), **EXACT)
    ref = jheat.decode_centers(jnp.asarray(hm))
    got = heatmap.decode_centers(_t(hm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0, 0] == 4 * 16 + 4 and got[2, 0] == 0


def test_uv_root_to_3d_and_perspective_project():
    rng = np.random.RandomState(6)
    B, res, dr = 4, 384, 4
    idx = rng.randint(0, (res // dr) ** 2, (B, 1)).astype(np.int32)
    off = rng.randn(B, 2).astype(np.float32)
    depth = rng.uniform(0.3, 0.8, B).astype(np.float32)
    K = np.tile(np.array([[[480.0, 0, 190.0], [0, 470.0, 195.0], [0, 0, 1]]],
                         np.float32), (B, 1, 1))
    ref = jgeo.uv_root_to_3d(jnp.asarray(idx), jnp.asarray(off),
                             jnp.asarray(depth), jnp.asarray(K), res, dr)
    got = geometry.uv_root_to_3d(_t(idx), _t(off), _t(depth), _t(K), res, dr)
    assert got.shape == (B, 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ELEM)

    pts = (rng.randn(B, 21, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    ref = jgeo.perspective_project(jnp.asarray(pts), jnp.asarray(K))
    got = geometry.perspective_project(_t(pts), _t(K))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PROD)


def test_orthographic_project_matches_jax_and_golden():
    g = np.load(os.path.join(GOLDENS, "geometry.npz"))
    ref = jgeo.orthographic_project(jnp.asarray(g["scale"]),
                                    jnp.asarray(g["trans2d"]),
                                    jnp.asarray(g["label3d"]), 384)
    got = geometry.orthographic_project(_t(g["scale"]), _t(g["trans2d"]),
                                        _t(g["label3d"]), 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ELEM)
    np.testing.assert_allclose(got.numpy(), g["proj"], atol=1e-4)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_cheb_basis_matches_jax(order):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 21, 6).astype(np.float32)
    L = rng.randn(21, 21).astype(np.float32) * 0.2
    ref = jcheb.cheb_basis(jnp.asarray(x), jnp.asarray(L), order)
    got = chebconv.cheb_basis(_t(x), _t(L), order)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PROD)


def test_cheb_conv_matches_golden():
    """basis @ W + b is the reference's graph_conv_cheby (gcn.py:34-69)."""
    g = np.load(os.path.join(GOLDENS, "cheb.npz"))
    y = chebconv.cheb_basis(_t(g["x"]), _t(g["L"]), 2) @ _t(g["W"]) + _t(g["b"])
    np.testing.assert_allclose(y.numpy(), g["y"], atol=1e-5)
