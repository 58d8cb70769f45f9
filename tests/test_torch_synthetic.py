"""The port's MANO layer, CenterNet targets, cloud sampler and synthetic
batches against the JAX package's.

- MANO (``pdfnet_tpu_torch.mano.layer``): against the reference's recorded
  outputs (``tests/goldens/mano.npz``) at ``tests/test_mano.py``'s
  tolerances, and against the JAX layer on seeded parameters within 2e-6
  (float32 products in another order; hand coordinates are ~0.1);
- ``centernet_targets`` and ``sample_hand_cloud``: numpy on both sides, so
  bit for bit on identical inputs and RNG state;
- ``make_batch``: every key against the JAX ``make_batch`` with the same
  seed.  Both take the numpy paths (``pdfnet_tpu.native.available``
  patched to False on the JAX side, which the port never reaches).  For the
  seeds here every key agrees within 1e-5 absolute plus 1e-6 relative
  (``BATCH_TOL``: a few float32 ulps of projected pixel coordinates, which
  reach 64, and of x / z for vertices close to the camera axis): the meshes
  differ by float32 rounding, and nothing derived from them crosses a pixel
  or cell boundary, so the sampled pixels, heatmaps and masks agree exactly
  (``EXACT_KEYS``).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu import native
from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.data import cloud as jax_cloud
from pdfnet_tpu.data import targets as jax_targets
from pdfnet_tpu.data.synthetic import make_batch as jax_make_batch
from pdfnet_tpu.mano import layer as jax_mano

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch.data import cloud, targets
from pdfnet_tpu_torch.mano import layer as mano
from test_torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
SMALL = dict(default_resolution=64, sample_num=256, sample_num_level1=128,
             sample_num_level2=128, knn_k=8)
MANO_TOL = 2e-6
BATCH_TOL = dict(rtol=1e-6, atol=1e-5)
BATCH_KEYS = ("input", "depth", "cloud", "choose", "hm", "hms", "wh",
              "off_hm", "off_lms", "ind", "valid", "mask", "mask_left_gt",
              "mask_right_gt", "lms", "K_new", "lms_left_gt", "lms_right_gt",
              "joints_left_gt", "joints_right_gt", "verts_left_gt",
              "verts_right_gt", "verts2d_left_gt", "verts2d_right_gt")


# keys that come from the meshes only through a rounding to pixels or
# cells (sampled pixels, heatmaps, masks), or not at all: these agree exactly
EXACT_KEYS = ("choose", "hm", "hms", "ind", "valid", "mask", "mask_left_gt",
              "mask_right_gt", "K_new")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "mano.npz"))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- MANO ------------------------------------------------------------------

@pytest.mark.parametrize("side", ["left", "right"])
def test_mano_axis_matches_golden(golden, side):
    v, j = mano.mano_forward(mano.load_mano_consts(side, device="cpu"),
                             _t(golden[f"{side}_root"]),
                             _t(golden[f"{side}_pose"]),
                             _t(golden[f"{side}_shape"]),
                             trans=_t(golden[f"{side}_trans"]))
    np.testing.assert_allclose(v.numpy(), golden[f"{side}_verts"], atol=2e-6)
    np.testing.assert_allclose(j.numpy(), golden[f"{side}_joints"], atol=2e-6)


@pytest.mark.parametrize("side", ["left", "right"])
def test_mano_pca_matches_golden(golden, side):
    v, j = mano.mano_forward(mano.load_mano_consts(side, device="cpu"),
                             _t(golden[f"{side}_rootmat"]),
                             _t(golden[f"{side}_pca"]),
                             _t(golden[f"{side}_shape"]),
                             trans=_t(golden[f"{side}_trans"]),
                             scale=_t(golden[f"{side}_scale"]), center_idx=9,
                             use_pca=True)
    np.testing.assert_allclose(v.numpy(), golden[f"{side}_verts_pca"],
                               atol=5e-6)
    np.testing.assert_allclose(j.numpy(), golden[f"{side}_joints_pca"],
                               atol=5e-6)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("fix_shape", [True, False])
def test_mano_matches_jax(side, fix_shape):
    rng = np.random.RandomState(7)
    root = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    pose = rng.uniform(-0.6, 0.6, (3, 45)).astype(np.float32)
    shape = rng.uniform(-2, 2, (3, 10)).astype(np.float32)
    trans = rng.uniform(-0.1, 0.1, (3, 3)).astype(np.float32)
    cj = jax_mano.load_mano_consts(side, fix_shape=fix_shape)
    ct = mano.load_mano_consts(side, fix_shape=fix_shape, device="cpu")
    np.testing.assert_array_equal(ct.shapedirs.numpy(),
                                  np.asarray(cj.shapedirs, np.float32))
    vj, jj = jax_mano.mano_forward(cj, root, pose, shape, trans=trans,
                                   center_idx=9)
    vt, jt = mano.mano_forward(ct, _t(root), _t(pose), _t(shape),
                               trans=_t(trans), center_idx=9)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=MANO_TOL)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=MANO_TOL)


def test_rotations_match_jax():
    rng = np.random.RandomState(8)
    axis = rng.uniform(-2, 2, (4, 45)).astype(np.float32)
    pca = rng.randn(4, 12).astype(np.float32)
    np.testing.assert_allclose(
        mano.axis_to_rmat(_t(axis)).numpy(),
        np.asarray(jax_mano.axis_to_rmat(jnp.asarray(axis))), atol=1e-6)
    np.testing.assert_allclose(
        mano.rodrigues(_t(axis[:, :3])).numpy(),
        np.asarray(jax_mano.rodrigues(jnp.asarray(axis[:, :3]))), atol=1e-6)
    np.testing.assert_allclose(
        mano.pca_to_axis(mano.load_mano_consts("right", device="cpu"),
                         _t(pca)).numpy(),
        np.asarray(jax_mano.pca_to_axis(jax_mano.load_mano_consts("right"),
                                        jnp.asarray(pca))), atol=1e-5)


# ---- targets and clouds ----------------------------------------------------

@pytest.fixture
def numpy_paths(monkeypatch):
    """The JAX package's numpy paths (the port has no native helper)."""
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("case", ["both", "left_invalid", "offscreen"])
def test_centernet_targets_bitwise(numpy_paths, case):
    rng = np.random.RandomState(9)
    left = rng.uniform(5, 59, (21, 2)).astype(np.float32)
    right = rng.uniform(5, 59, (21, 2)).astype(np.float32)
    valid = (0 if case == "left_invalid" else 1, 1)
    if case == "offscreen":          # landmarks at or below 0 are skipped
        right[:4] = -3.0
        left[:, 0] -= 20.0
    want = jax_targets.centernet_targets(left, right, *valid, 64, 4)
    got = targets.centernet_targets(left, right, *valid, 64, 4)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jax_targets.gaussian_radius((7.0, 9.0)) == \
        targets.gaussian_radius((7.0, 9.0))


def _masked_depth(seed, res=64, pixels=400):
    rng = np.random.RandomState(seed)
    depth = np.zeros((res, res), np.float32)
    flat = rng.choice(res * res, pixels, replace=False)
    depth.flat[flat] = rng.uniform(0.45, 0.65, pixels)
    K = np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]], np.float32)
    return depth, K


@pytest.mark.parametrize("case", ["subset", "wrap", "deterministic",
                                  "too_few"])
def test_sample_hand_cloud_bitwise(numpy_paths, case):
    pixels = {"subset": 900, "wrap": 300, "deterministic": 900,
              "too_few": 60}[case]
    depth, K = _masked_depth(10, pixels=pixels)
    det = case == "deterministic"
    rng_j, rng_t = np.random.RandomState(11), np.random.RandomState(11)
    cj, xj, okj = jax_cloud.sample_hand_cloud(depth, K, 256, rng_j,
                                              deterministic=det)
    ct, xt, okt = cloud.sample_hand_cloud(depth, K, 256, rng_t,
                                          deterministic=det)
    assert okt == okj == (case != "too_few")
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(xt, xj)
    assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)
    np.testing.assert_array_equal(cloud.backproject_np(depth, K),
                                  jax_cloud.backproject_np(depth, K))


# ---- synthetic batches -----------------------------------------------------

@pytest.fixture(scope="module")
def batches():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        want = jax_make_batch(JaxConfig(**SMALL), 3, seed=4)
    got = port.make_batch(port.Config(**SMALL), 3, seed=4)
    return got, want


def test_make_batch_keys(batches):
    got, want = batches
    assert sorted(got) == sorted(want) == sorted(BATCH_KEYS)
    assert got["valid"].sum() > 0


@pytest.mark.parametrize("key", BATCH_KEYS)
def test_make_batch_matches_jax(batches, key):
    got, want = batches
    assert got[key].shape == want[key].shape
    assert got[key].dtype == want[key].dtype
    np.testing.assert_allclose(got[key], want[key], **BATCH_TOL)
    if key in EXACT_KEYS:
        np.testing.assert_array_equal(got[key], want[key])


VARIANTS = [dict(input_feature_num=6), dict(sample_strategy="FPS"),
            dict(input_feature_num=6, sample_strategy="FPS")]


def _port_meshes(mp):
    """The JAX ``make_sample`` with the port's MANO in place of its own:
    the same meshes, so the same depth bits."""
    from pdfnet_tpu.data import synthetic as jax_synthetic
    from pdfnet_tpu_torch.data import synthetic

    def mano_forward(c, root, pose, shape, trans):
        side = "left" if c is jax_synthetic._consts("left") else "right"
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        with torch.no_grad():
            v, j = mano.mano_forward(synthetic._consts(side), t(root),
                                     t(pose), t(shape), trans=t(trans))
        return v.numpy(), j.numpy()
    mp.setattr(jax_synthetic, "mano", types.SimpleNamespace(
        mano_forward=mano_forward, load_mano_consts=jax_mano.load_mano_consts))


@pytest.mark.parametrize("variant", VARIANTS)
def test_make_batch_with_normals_and_fps_equals_jax(variant):
    """Normals appended to the clouds and the host FPS reordering, drawn
    from each sample's stream after both hands, on the same meshes (the
    JAX pipeline given the port's MANO): every key bit for bit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        _port_meshes(mp)
        want = jax_make_batch(JaxConfig(**SMALL, **variant), 2, seed=5)
    got = port.make_batch(port.Config(**SMALL, **variant), 2, seed=5)
    assert sorted(got) == sorted(want) == sorted(BATCH_KEYS)
    assert got["cloud"].shape[-1] == variant.get("input_feature_num", 3)
    assert got["valid"].sum() > 0
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("variant", VARIANTS)
def test_make_batch_with_normals_and_fps_matches_jax(variant):
    """The same against the JAX pipeline on its own meshes, whose depths
    differ from the port's by float32 rounding (``BATCH_TOL``).  Two inputs
    to the clouds are sensitive to such a last-bit difference:

    - at res 64 (focal length 80 px) det(A^T A) of the normals' plane fit
      is mostly over the guard's 1e-5, and the solve's condition number
      (~1e4) amplifies it: the normals agree within 2e-3, the tolerance of
      the JAX package's own host-against-device normals check;
    - FPS on the synthetic hands' 8x8-pixel blocks of equal depth meets
      exact distance ties, which the rounding breaks in another order: with
      FPS the clouds hold the same points (rows equal as sets), ordered
      otherwise."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        want = jax_make_batch(JaxConfig(**SMALL, **variant), 2, seed=5)
    got = port.make_batch(port.Config(**SMALL, **variant), 2, seed=5)
    fps = variant.get("sample_strategy") == "FPS"
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
        if key in ("cloud", "choose") and fps:
            continue
        g, w = got[key], want[key]
        if key == "cloud" and g.shape[-1] == 6:
            np.testing.assert_allclose(g[..., 3:], w[..., 3:], atol=2e-3)
            g, w = g[..., :3], w[..., :3]
        np.testing.assert_allclose(g, w, err_msg=key, **BATCH_TOL)
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=key)
    if fps:
        for b in range(2):
            for h in range(2):
                rows = lambda d: np.concatenate(
                    [d["choose"][b, h, :, None].astype(np.float64),
                     d["cloud"][b, h, :, :3]], axis=1)
                g, w = rows(got), rows(want)
                g, w = g[np.lexsort(g.T[::-1])], w[np.lexsort(w.T[::-1])]
                np.testing.assert_array_equal(g[:, 0], w[:, 0])
                np.testing.assert_allclose(g[:, 1:], w[:, 1:], **BATCH_TOL)


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_dataset_batches_match_jax(train):
    """``SyntheticHandDataset`` (the CLI's ``--synthetic`` data) gives
    JAX's batches in JAX's order: the train split shuffled with its tail
    dropped, the eval split in order with a padded, masked tail."""
    from pdfnet_tpu.data.synthetic import SyntheticHandDataset as JaxDataset
    from pdfnet_tpu_torch.data.synthetic import SyntheticHandDataset
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        want = list(JaxDataset(JaxConfig(**SMALL), size=5, seed=2,
                               train=train).batches(2, epoch=1))
    got = list(SyntheticHandDataset(port.Config(**SMALL), size=5, seed=2,
                                    train=train).batches(2, epoch=1))
    assert len(got) == len(want) == (2 if train else 3)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], **BATCH_TOL)
            if key in EXACT_KEYS or key == "pad_mask":
                np.testing.assert_array_equal(g[key], w[key])
