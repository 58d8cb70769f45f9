"""The port's MANO-parameter branch (``train/mano_branch.py``) against the
JAX one on seeded random thetas: ``split_coeff`` with and without PCA,
``mano_branch_forward`` with and without the translation, and
``mano_branch_loss`` on a full params map and on patch-head values
(B, 2, 122), with the gradients with respect to theta, within 1e-5
relative (float32 MANO in both, summed in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.train import mano_branch as jmb
from pdfnet_tpu.train import priors as jax_priors

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch.train import mano_branch as mb
from test_torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
B = 2
CFG = dict(default_resolution=64, sample_num=256, sample_num_level1=128,
           sample_num_level2=128, knn_k=8)


def jax_mano_branch_consts():
    """The JAX branch's constants, with the JAX prior's limit tables made
    outside any trace: ``pose_limits`` caches the arrays of its first call,
    and a first call under ``jax.jit`` would cache a tracer that a later
    trace cannot use."""
    jax_priors._LIMITS.clear()
    for table in ("left", "right", "h2o_left", "h2o_right"):
        jax_priors.pose_limits(table)
    return jmb.load_mano_branch_consts()


@pytest.fixture(scope="module")
def consts():
    return jax_mano_branch_consts(), mb.load_mano_branch_consts("cpu")


@pytest.fixture(scope="module")
def batch():
    return port.make_batch(port.Config(**CFG), B, seed=3)


def _theta(seed, shape=(B, 122)):
    # hand-sized values: the MANO pose near rest, small offsets
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)


def _close(got, want, what, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e} of its magnitude"


@pytest.mark.parametrize("num_pca", [0, 12])
def test_split_coeff_matches_jax(num_pca, batch):
    theta = _theta(0)
    ind, K = batch["ind"], batch["K_new"]
    want = jmb.split_coeff(jnp.asarray(theta), jnp.asarray(ind),
                           jnp.asarray(K), 64, 4, num_pca)
    got = mb.split_coeff(torch.from_numpy(theta), torch.from_numpy(ind),
                         torch.from_numpy(K), 64, 4, num_pca)
    for side in ("left", "right"):
        for k in ("orient", "pose", "shape", "trans"):
            assert got[side][k].shape == want[side][k].shape
            np.testing.assert_allclose(got[side][k].numpy(),
                                       np.asarray(want[side][k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{side} {k}")
    if not num_pca:
        assert not got["left"]["shape"].any()


@pytest.mark.parametrize("apply_trans", [True, False])
def test_mano_branch_forward_matches_jax(apply_trans, consts, batch):
    """Vertices and joints, and the gradient of a weighted sum of both
    with respect to theta."""
    theta = _theta(1)
    ind, K = jnp.asarray(batch["ind"]), jnp.asarray(batch["K_new"])
    w = np.random.RandomState(2).randn(2, B, 799, 3).astype(np.float32)

    def jax_fn(th):
        hands = jmb.mano_branch_forward(
            consts[0], jmb.split_coeff(th, ind, K, 64, 4),
            apply_trans=apply_trans)
        outs = [jnp.concatenate(hands[s], axis=1) for s in ("left", "right")]
        return sum((o * w[i]).sum() for i, o in enumerate(outs)), outs

    (_, want), grad_j = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(
        jnp.asarray(theta))
    th = torch.from_numpy(theta).requires_grad_()
    hands = mb.mano_branch_forward(
        consts[1], mb.split_coeff(th, torch.from_numpy(batch["ind"]),
                                  torch.from_numpy(batch["K_new"]), 64, 4),
        apply_trans=apply_trans)
    got = [torch.cat(hands[s], dim=1) for s in ("left", "right")]
    sum((o * torch.from_numpy(w[i])).sum() for i, o in enumerate(got)
        ).backward()
    for i, side in enumerate(("left", "right")):
        _close(got[i], want[i], side)
    _close(th.grad, grad_j, "d/dtheta")


@pytest.mark.parametrize("patch", [False, True])
def test_mano_branch_loss_matches_jax(patch, consts, batch):
    """Every loss term and the gradient with respect to the params map (a
    (B, 16, 16, 122) map read at the two centers, or the patch heads'
    (B, 2, 122) values)."""
    cfg_j, cfg_t = JaxConfig(**CFG), port.Config(**CFG)
    shape = (B, 2, 122) if patch else (B, 16, 16, 122)
    theta = _theta(4, shape)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    (loss_j, stats_j), grad_j = jax.jit(jax.value_and_grad(
        lambda m, b: jmb.mano_branch_loss(cfg_j, consts[0], m, b["ind"], b),
        has_aux=True))(jnp.asarray(theta), jb)
    th = torch.from_numpy(theta).requires_grad_()
    loss, stats = mb.mano_branch_loss(cfg_t, consts[1], th, tb["ind"], tb)
    loss.backward()
    assert sorted(stats) == sorted(stats_j)
    for k in stats_j:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(stats_j[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=RTOL)
    _close(th.grad, grad_j, "d/dtheta")
    if not patch:
        # only the two center cells of each sample receive a gradient
        assert int((th.grad.abs().sum(-1) > 0).sum()) <= 2 * B
