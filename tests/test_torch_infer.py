"""The self-contained RGB-D serving path of the port against the JAX one,
end to end: ``infer_rgbd`` + ``eval_outputs(..., {"K_new": K})`` with
``knn_method="pallas"`` and ``fused_trunk=True``.

Both packages run the same seeded random weights (carried across by
``convert.from_flax``) on the bench's random batch (``bench.py:56-68``:
input, depth uniform in 0.3-0.8 m, K, valid) at a small float32 config
with deterministic point sampling.  The JAX model runs, jitted, its Pallas trunk
kernel in interpret mode (``_TRUNK_INTERPRET``); its ``knn_method="pallas"``
runs the ``topk`` branch off the TPU (``grouping.py:79-80``), whose
neighbour sets equal the port's exact selection except at rounding-level
near ties.  The port runs the plain versions of its kernels.

Tolerance: ``atol=rtol=2e-4`` on every output, as for the eval step
(``test_torch_eval_step.py``).  The outputs depend discontinuously on the
predicted mask (a pixel at 0.5), on depths at the band edges and on
neighbour selections; the test asserts that both sides made the same
discrete choices (identical ``choose``, the same neighbour sets), so that a
changed seed fails clearly there instead of as a numeric mismatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdfnet_tpu.models.handnet as jax_handnet
from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import build_model as jax_build_model
from pdfnet_tpu.ops import grouping as jax_grouping
from pdfnet_tpu.ops import pallas_trunk
from pdfnet_tpu.train.loss import eval_outputs as jax_eval_outputs
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts

import pdfnet_tpu_torch as port
import pdfnet_tpu_torch.models.handnet as port_handnet
from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.ops import grouping as port_grouping
from pdfnet_tpu_torch.ops import sa, trunk

from test_torch_eval_step import SMALL, _batch, jax_variables
from test_torch_threads import one_torch_thread  # noqa: F401

SERVE = dict(SMALL, knn_method="pallas", fused_trunk=True,
             sample_deterministic=True)
TOL = dict(atol=2e-4, rtol=2e-4)
KEYS = ("verts_pred", "joints_pred", "verts_pred_off", "joints_pred_off",
        "lms21_pred")


def _recording(module, name, log):
    fn = getattr(module, name)

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append(out)
        return out
    return run


def _jax_recording(module, name, log):
    """``_recording`` from inside a jitted JAX function: each call's outputs
    reach ``log`` as numpy arrays through ``jax.debug.callback``."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(lambda *a: log.append(tuple(map(np.asarray, a))),
                           *out, ordered=True)
        return out
    return run


def _split_masks(variables, cfg, img):
    """Shift the mask head's bias so that each hand's predicted mask covers
    about half the image, with 0.5 in the widest gap between the mask values
    of its middle 40 %: at random weights the mask is nearly constant, and a
    value near 0.5 could flip between the two frameworks.  The bilinear
    resizes after the head keep a constant shift."""
    model = port.HandNet(port.Config(**cfg)).eval()
    model.load_state_dict(convert.from_flax(variables, model))
    with torch.inference_mode():
        mask = model.encoder.image_phase(
            torch.from_numpy(img).permute(0, 3, 1, 2), aux=False,
            need_mask=True)[1]
    head = variables["params"]["encoder"]["dp_decoder"]["head"]
    for c in range(mask.shape[1]):
        vals = np.sort(mask[:, c].numpy().ravel())
        lo, hi = int(0.3 * vals.size), int(0.7 * vals.size)
        i = lo + int(np.argmax(np.diff(vals[lo:hi])))
        head["bias"][c] += 0.5 - (vals[i] + vals[i + 1]) / 2


def run_serving(monkeypatch):
    cfg_j = JaxConfig(**SERVE)
    B, res, n = 2, cfg_j.default_resolution, cfg_j.sample_num
    batch = _batch(B, res, n)
    variables = jax_variables(cfg_j, batch)
    _split_masks(variables, SERVE, batch["input"])
    inputs = [batch[k] for k in ("input", "depth", "K_new", "valid")]

    jax_clouds, jax_nbrs = [], []
    monkeypatch.setattr(pallas_trunk, "_TRUNK_INTERPRET", True)
    monkeypatch.setattr(jax_handnet, "depth_to_hand_clouds", _jax_recording(
        jax_handnet, "depth_to_hand_clouds", jax_clouds))
    monkeypatch.setattr(jax_grouping, "knn_ball_query", _jax_recording(
        jax_grouping, "knn_ball_query", jax_nbrs))
    model_j, consts_j = jax_build_model(cfg_j), jax_consts()

    def serve(v, img, depth, K, valid, key):
        out = jax_handnet.infer_rgbd(model_j, v, img, depth, K, valid, key)
        return jax_eval_outputs(cfg_j, consts_j, *out, {"K_new": K}), \
            out[3]["mask"]

    # one compile: run eagerly, the apply dispatches its ~1,000 primitives
    # (the interpret-mode trunk kernel among them) one by one
    with jax.default_matmul_precision("highest"):
        ref, mask_j = jax.jit(serve)(variables, *map(jnp.asarray, inputs),
                                     jax.random.PRNGKey(0))
        jax.effects_barrier()
    ref = {k: np.asarray(ref[k]) for k in KEYS}
    mask_j = np.asarray(mask_j)

    port_clouds, port_nbrs = [], []
    monkeypatch.setattr(port_handnet, "depth_to_hand_clouds", _recording(
        port_handnet, "depth_to_hand_clouds", port_clouds))
    monkeypatch.setattr(port_grouping, "knn_ball_query", _recording(
        port_grouping, "knn_ball_query", port_nbrs))
    cfg_t = port.Config(**SERVE)
    model = port.HandNet(cfg_t).eval()
    model.load_state_dict(convert.from_flax(variables, model))
    sa.reset_launches()
    trunk.reset_launches()
    got = port.infer_rgbd(model, *inputs)
    got = port.eval_outputs(cfg_t, port.load_loss_consts("cpu"), *got,
                            {"K_new": torch.from_numpy(batch["K_new"])})
    got = {k: got[k].numpy() for k in KEYS}
    return dict(ref=ref, got=got, mask_j=mask_j, batch=batch,
                clouds=(jax_clouds, port_clouds), nbrs=(jax_nbrs, port_nbrs))


def test_serving_matches_jax(monkeypatch):
    """One JAX reference (the expensive part) behind one test: the same
    discrete choices (clouds from the predicted masks, neighbour sets at
    both levels), then every output within TOL, finite at its shape, and no
    kernel launched on CPU tensors."""
    torch.set_num_threads(1)
    run = run_serving(monkeypatch)
    (jc,), (pc,) = run["clouds"]
    margin = np.abs(run["mask_j"] - 0.5).min()
    assert margin > 1e-5, f"a mask value {margin:.2e} from 0.5"
    assert np.asarray(jc[2]).all(), "a hand got no cloud: the seed is weak"
    np.testing.assert_array_equal(pc[0].numpy(), np.asarray(jc[0]))
    np.testing.assert_array_equal(pc[2].numpy(), np.asarray(jc[2]))
    cj = np.asarray(jc[1])
    assert np.abs(pc[1].numpy() - cj).max() <= 1e-6 * np.abs(cj).max()
    jn, pn = run["nbrs"]
    assert len(jn) == len(pn) == 2
    for (idx_j, _), (idx_t, _) in zip(jn, pn):
        np.testing.assert_array_equal(np.sort(idx_t.numpy(), -1),
                                      np.sort(np.asarray(idx_j), -1),
                                      err_msg="neighbour sets differ")

    B = run["batch"]["input"].shape[0]
    shapes = {"verts_pred": (B, 2, 778, 3), "joints_pred": (B, 2, 21, 3),
              "verts_pred_off": (B, 2, 778, 3),
              "joints_pred_off": (B, 2, 21, 3), "lms21_pred": (B, 2, 21, 2)}
    for key in KEYS:
        got, ref = run["got"][key], run["ref"][key]
        assert got.shape == shapes[key] and np.isfinite(got).all(), key
        np.testing.assert_allclose(got, ref, **TOL, err_msg=key)
    assert not any(sa.launches.values())
    assert not any(trunk.launches.values())


def _port_model(**kw):
    torch.set_num_threads(1)
    cfg = port.Config(**dict(SERVE, **kw))
    return cfg, port.build_model(cfg, device="cpu")


def test_infer_rgbd_random_sampling_follows_the_generator():
    """Random mode: the same generator seed gives the same outputs, another
    seed other clouds; the mask, the decoded centers and the clouds come
    back in ``other``."""
    cfg, model = _port_model(sample_deterministic=False)
    with torch.no_grad():        # both masks cover the whole image
        model.encoder.dp_decoder.head.bias.fill_(10.0)
    batch = _batch(1, cfg.default_resolution, cfg.sample_num)
    args = [batch[k] for k in ("input", "depth", "K_new", "valid")]
    clouds = []
    log = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_handnet, "depth_to_hand_clouds", _recording(
            port_handnet, "depth_to_hand_clouds", log))
        for seed in (0, 0, 1):
            gen = torch.Generator().manual_seed(seed)
            out = port.infer_rgbd(model, *args, generator=gen)
            clouds.append(log[-1][1])
    assert out[3]["mask"].shape == (1, 64, 64, 2)
    assert out[3]["ind"].shape == (1, 2)
    assert clouds[0].abs().sum(-1).gt(0).all(), "an empty cloud"
    assert torch.equal(clouds[0], clouds[1])
    assert not torch.equal(clouds[0], clouds[2])
