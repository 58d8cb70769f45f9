"""The port's serving and demo CLIs (``pdfnet_tpu_torch.cli.infer``,
``pdfnet_tpu_torch.cli.demo``) against the JAX package's, end to end on
color/depth PNG pairs that the test writes (uint8 color, uint16 depth in
millimetres, 3 frames of 96x128).

Both CLIs build their own ``Config`` (bfloat16, random cloud sampling);
the test wraps ``build_model`` in each package's namespace to take
``compute_dtype="float32"`` and ``sample_deterministic=True``, the only
settings under which the two can agree value for value (random sampling
agrees only in distribution).  The weights are one seeded flax tree
(``test_torch_eval_step.jax_variables``) with the mask head's bias shifted
as ``test_torch_infer._split_masks`` does, saved as a JAX checkpoint for
the JAX CLI and, through ``convert.from_flax``, as a port checkpoint for
the port's.  The JAX model runs its Pallas kernels in interpret mode.

Tolerance: every output within 2e-4 of its magnitude, as for the serving
step (``test_torch_infer.py``).  The names must be equal (the padded tail
dropped) and ``hand_poses.json`` must have the same keys and 126 floats a
frame.
"""

import json
import os
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdfnet_tpu.models as jax_models
from pdfnet_tpu.cli import infer as jax_infer
from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.ops import grouping as jax_grouping
from pdfnet_tpu.render import rasterizer as jax_rast
from pdfnet_tpu.train import checkpoint as jax_ckpt
from pdfnet_tpu.train.step import TrainState

import pdfnet_tpu_torch as port
import pdfnet_tpu_torch.models.handnet as port_handnet
from pdfnet_tpu_torch import assets, convert
from pdfnet_tpu_torch.cli import demo as port_demo
from pdfnet_tpu_torch.cli import infer as port_infer
from pdfnet_tpu_torch.render import rasterizer
from pdfnet_tpu_torch.train.checkpoint import save_checkpoint
from pdfnet_tpu_torch.train.step import create_train_state

from test_torch_eval_step import SMALL, _batch, jax_variables
from test_torch_infer import _split_masks

FLAGS = ["--res", "64", "--sample_num", "256", "--sample_num_level1", "128",
         "--sample_num_level2", "128", "--knn_k", "8", "--cpu"]
NAMES = ["000000", "000001", "000002"]
KEYS = ("joints_abs", "joints_rel", "verts_abs", "lms2d")


def write_frames(root, seed=0, h=96, w=128):
    """color/NNNNNN.png (smooth uint8 BGR) and depth/NNNNNN.png (uint16 mm,
    a tilted surface 0.45-0.65 m with a bump) for each of NAMES."""
    rng = np.random.RandomState(seed)
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    for name in NAMES:
        base = rng.uniform(40, 200, 3)
        img = (base + 40 * np.sin(xx[..., None] / rng.uniform(8, 20)
                                  + yy[..., None] / rng.uniform(8, 20)))
        cv2.imwrite(os.path.join(root, "color", f"{name}.png"),
                    np.clip(img, 0, 255).astype(np.uint8))
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        depth = (450 + 1.2 * xx + 0.6 * yy
                 - 60 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 300))
        cv2.imwrite(os.path.join(root, "depth", f"{name}.png"),
                    depth.astype(np.uint16))


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(frames, tmp):
    """One flax tree (mask head split on these frames' crops), saved as a
    JAX and a port checkpoint; returns their paths."""
    cfg = JaxConfig(**SMALL)
    variables = jax_variables(cfg, _batch(1, cfg.default_resolution,
                                          cfg.sample_num))
    K = port_demo.demo_intrinsics()
    mean, std = (np.asarray(v, np.float32) for v in (cfg.mean, cfg.std))
    img = np.stack([port_infer._preprocess(
        os.path.join(frames, "color", f"{n}.png"), cfg.default_resolution,
        mean, std, K)[0] for n in NAMES])
    _split_masks(variables, SMALL, img)
    jax_path = jax_ckpt.save_checkpoint(
        os.path.join(tmp, "jax_ckpt"),
        TrainState(params=variables["params"],
                   batch_stats=variables["batch_stats"], opt_state={},
                   step=np.zeros((), np.int32)), 0)
    model = port.HandNet(port.Config(**SMALL))
    model.load_state_dict(convert.from_flax(variables, model))
    port_path = save_checkpoint(os.path.join(tmp, "port_ckpt"),
                                create_train_state(port.Config(**SMALL),
                                                   model), 0)
    return jax_path, port_path


def _parity_model(build):
    def wrapped(cfg, *args, **kwargs):
        return build(cfg.replace(compute_dtype="float32",
                                 sample_deterministic=True), *args, **kwargs)
    return wrapped


class _ZeroInit:
    """A JAX model whose ``init`` gives zeros of the variables' shapes (from
    ``jax.eval_shape`` of the ``topk`` model, whose tree is the same, as
    ``bench.py`` notes): the CLI overlays every leaf from the checkpoint,
    and an eager init through the interpret-mode kernels takes over a
    minute on the CPU."""

    def __init__(self, model, shapes_model):
        self._model, self._shapes_model = model, shapes_model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, *args, **kwargs):
        shapes = jax.eval_shape(
            lambda: self._shapes_model.init(*args, **kwargs))
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _jax_parity_model(build):
    parity = _parity_model(build)

    def wrapped(cfg):
        return _ZeroInit(parity(cfg), parity(cfg.replace(
            knn_method="topk", gather_method="take")))
    return wrapped


def _load(out):
    preds = dict(np.load(os.path.join(out, "predictions.npz")))
    with open(os.path.join(out, "hand_poses.json")) as f:
        return preds, json.load(f)


def test_infer_cli_matches_jax(tmp_path, monkeypatch, one_torch_thread):
    """3 frames at --batch 2 (a padded tail batch) through both CLIs."""
    frames = str(tmp_path / "frames")
    write_frames(frames)
    jax_path, port_path = _weights(frames, str(tmp_path))

    monkeypatch.setattr(jax_models, "build_model",
                        _jax_parity_model(jax_models.build_model))
    monkeypatch.setattr(jax_grouping, "_FUSED_INTERPRET", True)
    with jax.default_matmul_precision("highest"):
        jax_infer.main(["--input", frames, "--batch", "2", "--json",
                        "--ckpt", jax_path, "--out", str(tmp_path / "j")]
                       + FLAGS)
    monkeypatch.setattr(port_handnet, "build_model",
                        _parity_model(port_handnet.build_model))
    port_infer.main(["--input", frames, "--batch", "2", "--json", "--ckpt",
                     port_path, "--out", str(tmp_path / "p")] + FLAGS)

    (ref, sub_j), (got, sub_p) = _load(tmp_path / "j"), _load(tmp_path / "p")
    assert list(got["names"]) == list(ref["names"]) == NAMES
    shapes = {"joints_abs": (3, 2, 21, 3), "joints_rel": (3, 2, 21, 3),
              "verts_abs": (3, 2, 778, 3), "lms2d": (3, 2, 21, 2)}
    for key in KEYS:
        g, r = got[key], ref[key]
        assert g.shape == r.shape == shapes[key] and np.isfinite(g).all()
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-4 * scale, rtol=0,
                                   err_msg=key)
    assert list(sub_p) == list(sub_j) == NAMES
    assert all(len(v) == 126 for v in sub_p.values())
    np.testing.assert_allclose(np.array(list(sub_p.values())),
                               np.array(list(sub_j.values())),
                               atol=2e-4 * max(1.0, float(np.abs(
                                   ref["joints_abs"]).max())), rtol=0)

    # the port's renderer on the predicted meshes against the JAX renderer
    K = port_infer._preprocess(os.path.join(frames, "color", "000000.png"),
                               64, 0.0, 1.0, port_demo.demo_intrinsics())[2]
    faces = (assets.load_mano("left").faces, assets.load_mano("right").faces)
    vl, vr = got["verts_abs"][0]
    rj = jax_rast.render_two_hands(jnp.asarray(vl), jnp.asarray(vr),
                                   jnp.asarray(K), *faces, 64, 64)
    rp = rasterizer.render_two_hands(torch.from_numpy(vl),
                                     torch.from_numpy(vr),
                                     torch.from_numpy(K), *faces, 64, 64)
    np.testing.assert_array_equal(rp[1].numpy(), np.asarray(rj[1]))
    assert rp[1].sum() > 0
    for a, b in ((rp[0], rj[0]), (rp[2], rj[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def _run_with_timeout(fn, seconds):
    """fn() in a daemon thread: (finished, exception raised or None)."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:   # handed back to the test
            box["e"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    return not t.is_alive(), box.get("e")


def test_missing_depth_raises_naming_the_file(tmp_path, one_torch_thread):
    """The last frame has no depth PNG: the first batch is served, then the
    producer's failure reaches the caller within 30 s (the JAX CLI's
    consumer waits for ever), naming the file."""
    frames = str(tmp_path / "frames")
    write_frames(frames)
    os.remove(os.path.join(frames, "depth", "000002.png"))
    done, err = _run_with_timeout(lambda: port_infer.main(
        ["--input", frames, "--batch", "2", "--out", str(tmp_path / "p")]
        + FLAGS), 30)
    assert done, "the serving CLI hung on a frame without depth"
    assert isinstance(err, RuntimeError), repr(err)
    assert os.path.join(frames, "color", "000002.png") in str(err)
    assert os.path.join(frames, "depth", "000002.png") in str(err)
    assert not os.path.exists(tmp_path / "p" / "predictions.npz")


def test_batches_stop_their_threads(tmp_path):
    """A consumer that leaves after the first batch, or meets a failure,
    leaves no producer or pool thread behind."""
    frames = str(tmp_path / "frames")
    write_frames(frames)
    files = [os.path.join(frames, "color", f"{n}.png") for n in NAMES]
    K = port_demo.demo_intrinsics()
    before = set(threading.enumerate())
    it = port_infer._batches(files, 1, 32, 0.0, 1.0, K)
    chunk, n, inp, depth, K_img = next(it)
    assert chunk == files[:1] and n == 1 and inp.shape == (1, 32, 32, 3)
    assert depth.dtype == np.float32 and K_img.shape == (1, 3, 3)
    it.close()
    assert set(threading.enumerate()) == before
    with pytest.raises(RuntimeError, match="nowhere.png"):
        list(port_infer._batches(files + ["nowhere.png"], 2, 32, 0.0, 1.0,
                                 K))
    assert set(threading.enumerate()) == before


def test_batches_pad_the_tail(tmp_path):
    frames = str(tmp_path / "frames")
    write_frames(frames)
    files = [os.path.join(frames, "color", f"{n}.png") for n in NAMES]
    got = list(port_infer._batches(files, 2, 32, 0.0, 1.0,
                                   port_demo.demo_intrinsics()))
    assert [(c, n) for c, n, *_ in got] == [(files[:2], 2), (files[2:], 1)]
    tail = got[1][2]
    assert tail.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(tail[0], tail[1])


def test_load_rgbd_and_crop_match_jax(tmp_path):
    """float64 depth through the nearest-neighbour warp, then float32: the
    same arrays and intrinsics as the JAX CLI's preprocessing."""
    frames = str(tmp_path / "frames")
    write_frames(frames)
    f = os.path.join(frames, "color", "000001.png")
    K = port_demo.demo_intrinsics()
    np.testing.assert_array_equal(K, jax_infer.demo_intrinsics())
    image, depth = port_demo.load_rgbd(f)
    assert image.dtype == np.uint8 and depth.dtype == np.float64
    mean, std = np.float32([0.4, 0.5, 0.6]), np.float32([0.2, 0.3, 0.25])
    for a, b in zip(port_infer._preprocess(f, 64, mean, std, K),
                    jax_infer._preprocess(f, 64, mean, std, K)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_demo_cli_writes_its_images(tmp_path, one_torch_thread):
    frames = str(tmp_path / "frames")
    write_frames(frames)
    out = str(tmp_path / "demo")
    port_demo.main(["--input", frames, "--limit", "2", "--out", out, "--res",
                    "128"] + FLAGS[2:])
    got = sorted(os.listdir(os.path.join(out, "color")))
    assert got == sorted(f"{p}_{n}.jpg" for n in NAMES[:2]
                         for p in ("bones_lr", "mask_lr", "render"))
    for name in got:
        img = cv2.imread(os.path.join(out, "color", name))
        assert img is not None and img.shape == (128, 128, 3), name
