"""The port's ``compute_loss`` against the JAX one, term by term.

Both take the same numpy model outputs (seeded, at the shapes the model
gives at res 64) and the same synthetic batch, and every key of ``stats``
must agree within ``rtol=1e-5`` (float32 sums in another order).  The cases
cover the epoch gate on the edge and 2-D joint terms, both focal-loss guards
(per sample, and the reference's batch-global one under
``replicate_reference_quirks`` with its GCN quirks), the ``off`` heads, the
``wh`` term, and a joints-only batch (no vertex ground truth).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.train.loss import compute_loss as jax_compute_loss
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts

import pdfnet_tpu_torch as port

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8)
TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def consts():
    return jax_consts(), port.load_loss_consts("cpu")


def _outputs(cfg, batch, seed):
    """Seeded model outputs: (result, params, hand_dicts, other) as numpy."""
    rng = np.random.RandomState(seed)
    B, res = batch["input"].shape[0], cfg.default_resolution
    h = res // cfg.down_ratio
    side = lambda *shape, s=1.0: {k: (rng.randn(B, *shape) * s).astype(np.float32)
                                  for k in ("left", "right")}
    px = lambda n: {k: rng.uniform(0, res, (B, n, 2)).astype(np.float32)
                    for k in ("left", "right")}
    result = {"verts3d": side(778, 3, s=0.05), "verts2d": px(778)}
    params = {"root": side(3, s=5.0)}
    hand_dicts = [{"verts3d": side(252, 3, s=0.05), "verts2d": px(252)}]
    ret = {name: rng.randn(B, h, h, c).astype(np.float32)
           for name, c in cfg.heads.items()}
    other = {"ret": ret,
             "hms": rng.uniform(0, 1, batch["hms"].shape).astype(np.float32),
             "mask": rng.uniform(0, 1, batch["mask"].shape).astype(np.float32),
             "ind": batch["ind"]}
    return result, params, hand_dicts, other


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


CASES = {
    "default": (dict(), 30, None),
    "before_edge_epoch": (dict(), 0, None),
    "quirks_batch_guard": (dict(replicate_reference_quirks=True), 30, None),
    "sample_without_positive": (dict(), 30, "no_pos_1"),
    "batch_without_positive": (dict(replicate_reference_quirks=True), 30,
                               "no_pos_all"),
    "off_heads": (dict(off=True), 30, None),
    "wh_loss": (dict(use_wh_loss=True), 30, None),
    "joints_only": (dict(), 30, "joints_only"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_loss_matches_jax(consts, case):
    overrides, epoch, edit = CASES[case]
    cfg_t = port.Config(**SMALL, **overrides)
    cfg_j = JaxConfig(**SMALL, **overrides)
    batch = port.make_batch(cfg_t, 2, seed=3)
    assert (batch["hm"] == 1.0).reshape(2, -1).any(axis=1).all()
    if edit == "no_pos_1":       # sample 1 has no heatmap peak of 1
        batch["hm"][1] *= 0.5
    elif edit == "no_pos_all":   # no sample has one: the batch-global guard
        batch["hm"] *= 0.5
    elif edit == "joints_only":  # RHD-style: no vertex ground truth
        batch = {k: v for k, v in batch.items()
                 if not k.startswith(("verts_", "verts2d_"))}
    outs = _outputs(cfg_t, batch, seed=4)

    loss_j, stats_j = jax_compute_loss(
        cfg_j, consts[0], *_map(outs, jnp.asarray),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(epoch),
        mode="train")
    loss_t, stats_t = port.compute_loss(
        cfg_t, consts[1], *_map(outs, torch.from_numpy),
        {k: torch.from_numpy(v) for k, v in batch.items()}, epoch,
        mode="train")

    assert sorted(stats_t) == sorted(stats_j)
    for k in stats_j:
        np.testing.assert_allclose(stats_t[k].numpy(), np.asarray(stats_j[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), **TOL)
    if edit == "joints_only":
        for k in ("verts_loss", "abs_verts_loss", "gcn_loss", "norm_loss",
                  "edge_loss", "verts2d_loss", "gcn_2d_loss"):
            assert float(stats_t[k]) == 0.0, k
        for k in ("joints_loss", "abs_joints_loss", "joints2d_loss"):
            assert float(stats_t[k]) > 0.0, k


def test_epoch_gate_drops_edge_and_joints2d_terms(consts):
    """Before ``edge_loss_start_epoch`` the total misses exactly the edge
    and 2-D joint terms (weights 2000 and 1000)."""
    cfg = port.Config(**SMALL)
    batch = {k: torch.from_numpy(v)
             for k, v in port.make_batch(cfg, 2, seed=5).items()}
    outs = _map(_outputs(cfg, port.make_batch(cfg, 2, seed=5), seed=6),
                torch.from_numpy)
    late, st = port.compute_loss(cfg, consts[1], *outs, batch,
                                 cfg.edge_loss_start_epoch)
    early, _ = port.compute_loss(cfg, consts[1], *outs, batch,
                                 cfg.edge_loss_start_epoch - 1)
    gated = cfg.reproj_weight * (2000.0 * st["edge_loss"]
                                 + 1000.0 * st["joints2d_loss"])
    np.testing.assert_allclose((late - early).numpy(), gated.numpy(),
                               rtol=1e-4)


def test_photometric_loss_adds_its_terms_and_mines(consts):
    """``photometric_loss`` adds ``photo + 20 * seg`` to each sample's loss
    and returns the mean of the hardest ``max(int(0.7 B), 1)`` samples
    (``tests/test_torch_photometric.py`` holds the terms to JAX)."""
    cfg = port.Config(**SMALL, photometric_loss=True)
    host = port.make_batch(cfg, 4, seed=7)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    outs = _map(_outputs(cfg, host, seed=8), torch.from_numpy)
    total, st = port.compute_loss(cfg, consts[1], *outs, batch, 30)
    base, _ = port.compute_loss(cfg.replace(photometric_loss=False),
                                consts[1], *outs, batch, 30)
    assert "photometric_loss" in st and "seg_loss" in st
    assert torch.isfinite(total) and float(st["seg_loss"]) > 0
    # base is the mean of the per-sample loss the mining sees minus the
    # photometric terms; the mined total is at least the batch mean
    per_mean = base + st["photometric_loss"] + 20.0 * st["seg_loss"]
    assert float(total) >= float(per_mean) * (1 - 1e-6)
