"""The port's batched RGB-D eval step against the JAX one, end to end.

Both packages run the same seeded random weights (every flax leaf drawn with
numpy, BatchNorm statistics included, carried across by
``pdfnet_tpu_torch.convert.from_flax``) on the bench's batch layout
(``bench.py:57-68``) at a small float32 config.  The JAX model takes its
``knn_method="pallas_sa"`` path with the Pallas kernels in interpret mode;
the port runs the plain versions of its kernels (CPU tensors).

Tolerance: ``atol=rtol=2e-4`` on every ``eval_outputs`` key.  The two
frameworks sum the convolutions of a ResNet-50 in different orders (float32
rounding of ~1e-6 relative per layer); at these weights the largest
difference seen is 7e-6 absolute on verts of magnitude ~7 and 1e-5 relative
on the projected landmarks (values up to ~2e4 where z is near 0).  2e-4
leaves an order of magnitude of headroom and still catches a wrong layout,
epsilon or neighbour set, which move the outputs by >1e-2.
"""

import jax
import numpy as np
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import build_model as jax_build_model
from pdfnet_tpu.ops import grouping
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts
from pdfnet_tpu.train.step import make_eval_step as jax_eval_step

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.ops import sa
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_threads import shared_across_workers

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8)
TOL = dict(atol=2e-4, rtol=2e-4)


def _batch(B, res, n, seed=0):
    """The bench's batch dict (bench.py:57-68) plus ground truth."""
    rng = np.random.RandomState(seed)
    return {
        "input": rng.randn(B, res, res, 3).astype(np.float32),
        "choose": rng.randint(0, res * res, (B, 2, n)).astype(np.int32),
        "cloud": rng.uniform(-0.1, 0.1, (B, 2, n, 3)).astype(np.float32),
        "depth": rng.uniform(0.3, 0.8, (B, res, res)).astype(np.float32),
        "K_new": np.tile(np.array([[[480.0, 0, res / 2], [0, 480.0, res / 2],
                                    [0, 0, 1]]], np.float32), (B, 1, 1)),
        "valid": np.ones((B, 2), np.float32),
        "verts_left_gt": rng.randn(B, 778, 3).astype(np.float32) * 0.05,
        "verts_right_gt": rng.randn(B, 778, 3).astype(np.float32) * 0.05,
        "joints_left_gt": rng.randn(B, 21, 3).astype(np.float32) * 0.05,
        "joints_right_gt": rng.randn(B, 21, 3).astype(np.float32) * 0.05,
    }


def _random_like(tree, rng, path=()):
    """Seeded numpy values for every leaf of a flax variables tree (shapes
    from ``jax.eval_shape``, so no flax init runs).  Kernels are scaled by
    1/sqrt(fan_in); biases, norm gains and BN running statistics are
    randomized too, so no fold, norm or bias is the identity."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _random_like(v, rng, path + (k,))
            continue
        shape = v.shape
        if k in ("kernel", "embedding"):
            fan_in = int(np.prod(shape[:-1])) if k == "kernel" else shape[-1]
            a = rng.randn(*shape) / np.sqrt(fan_in)
        elif k == "var":
            a = rng.uniform(0.5, 2.0, shape)
        elif k == "scale" or (k == "weight" and path[-1].endswith("_l2")):
            a = (10.0 if k == "weight" else 1.0) + rng.uniform(-0.3, 0.3, shape)
        else:                                    # bias, mean
            a = rng.uniform(-0.3, 0.3, shape)
        out[k] = a.astype(np.float32)
    return out


def jax_variables(cfg, batch, seed=1):
    """Random variables for the JAX HandNet at ``cfg`` (see _random_like)."""
    model = jax_build_model(cfg.replace(knn_method="topk",
                                        gather_method="take"))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch["input"][:1],
        batch["choose"][:1], batch["cloud"][:1], batch["depth"][:1], None,
        batch["K_new"][:1], batch["valid"][:1], train=False))
    rng = np.random.RandomState(seed)
    return {c: _random_like(shapes[c], rng) for c in ("params", "batch_stats")}


def run_slice():
    cfg_j = JaxConfig(**SMALL)
    B, res, n = 2, cfg_j.default_resolution, cfg_j.sample_num
    batch = _batch(B, res, n)
    variables = jax_variables(cfg_j, batch)

    old = grouping._FUSED_INTERPRET
    grouping._FUSED_INTERPRET = True
    try:
        step = jax_eval_step(cfg_j, jax_build_model(cfg_j), jax_consts())
        ref = step(variables["params"], variables["batch_stats"],
                   {k: jax.numpy.asarray(v) for k, v in batch.items()})
        ref = {k: np.asarray(v) for k, v in ref.items()}
    finally:
        grouping._FUSED_INTERPRET = old

    cfg_t = port.Config(**SMALL)
    model = port.HandNet(cfg_t).eval()
    model.load_state_dict(convert.from_flax(variables, model))
    sa.reset_launches()
    got = port.make_eval_step(cfg_t, model,
                              port.load_loss_consts("cpu"))(batch)
    return ref, {k: v.numpy() for k, v in got.items()}, dict(sa.launches)


@pytest.fixture(scope="module")
def slice_outputs(tmp_path_factory):
    """(JAX's outputs, the port's, the port's kernel launches), computed
    once for the run's workers."""
    return shared_across_workers(tmp_path_factory, "eval_step_slice",
                                 run_slice)


def test_eval_step_keys_and_shapes(slice_outputs):
    ref, got, _ = slice_outputs
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert got[k].dtype == np.float32, k
        assert np.isfinite(got[k]).all(), k


@pytest.mark.parametrize("key", [
    "verts_pred", "joints_pred", "verts_pred_off", "joints_pred_off",
    "lms21_pred", "verts_gt", "joints_gt", "verts_gt_off", "joints_gt_off"])
def test_eval_step_matches_jax(slice_outputs, key):
    ref, got, _ = slice_outputs
    np.testing.assert_allclose(got[key], ref[key], **TOL)


def test_cpu_eval_launches_no_kernel(slice_outputs):
    """On CPU tensors the wrappers run their plain versions only (the
    counts as the eval step left them)."""
    launches = slice_outputs[2]
    assert launches and all(v == 0 for v in launches.values())


def test_build_model_defaults_to_the_card():
    """Without a GPU the default device raises instead of running on CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.build_model(port.Config(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.load_loss_consts()
