"""The port's dataset (``pdfnet_tpu_torch.data.h2o``) against the JAX
package's ``H2ODataset.__getitem__``, key by key, on the fixture trees of
``tests/test_h2o_dataset.py`` (H2O, H2O3D and the single-hand FreiHAND,
HO3D and OneHand10K trees) and on a joints-only RHD tree built here, in the
train split (flip, brightness, jitter and rotation drawn per sample and
epoch) and the test split, with the same seed and epoch.

Both packages draw every random choice from the same numpy streams and use
the same C++ helpers (the JAX package's default where its library builds;
``native=True`` here) or, in ``test_numpy_paths_equal_jax``, both the numpy
versions.  So:

- every key that does not depend on MANO is equal bit for bit;
- the MANO-derived float keys (vertices and joints in 3-D, their
  projections, the CenterNet sizes and offsets taken from the projected
  joints) agree within 1e-5 relative: the two packages' MANO layers agree
  only to float32 rounding;
- the integer keys a float32 MANO difference could move, because they
  round projected joints to pixels of the /4 grid, are ``ind`` and the
  heatmaps ``hm`` and ``hms`` drawn at those pixels, and ``valid``
  through the landmark box; they are equal on these fixtures.
"""

import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from pdfnet_tpu import native as jax_native
from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.data.h2o import H2ODataset as JaxDataset

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data.h2o import H2ODataset, build_dataset
from pdfnet_tpu_torch.mano import layer as mano

from test_h2o_dataset import _single_hand_tree, h2o3d_tree, h2o_tree  # noqa
from test_torch_threads import one_torch_thread  # noqa: F401

MANO_KEYS = ("verts_left_gt", "verts_right_gt", "verts2d_left_gt",
             "verts2d_right_gt", "joints_left_gt", "joints_right_gt",
             "lms_left_gt", "lms_right_gt", "wh", "off_hm", "off_lms")
ROUNDED_KEYS = ("ind", "hm", "hms", "valid")
MANO_TOL = dict(rtol=1e-5, atol=1e-5)


def _compare(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in MANO_KEYS:
            np.testing.assert_allclose(g, w, err_msg=k, **MANO_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _pair(root, dataset, split, **kw):
    kw = dict(cache_path=root, pre_fix=root, dataset=dataset,
              sample_num=256, default_resolution=64, **kw)
    return H2ODataset(Config(**kw), split), JaxDataset(JaxConfig(**kw), split)


@pytest.fixture(scope="module")
def jax_native_built():
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")


@pytest.mark.parametrize("split,epoch", [("train", 0), ("train", 3),
                                         ("test", 0)])
def test_h2o_equals_jax(h2o_tree, jax_native_built, split, epoch):
    port, ref = _pair(h2o_tree, "H2O", split)
    assert len(port) == len(ref) == 3
    for i in range(len(ref)):
        _compare(port.__getitem__(i, epoch), ref.__getitem__(i, epoch))


def test_h2o3d_equals_jax(h2o3d_tree, jax_native_built):
    port, ref = _pair(h2o3d_tree, "H2O3D", "test")
    for i in range(len(ref)):
        _compare(port[i], ref[i])


@pytest.mark.parametrize("name,split,depth,mask", [
    ("FreiHAND", "train", False, False), ("HO3D", "test", True, True),
    ("OneHand10K", "test", True, True), ("OneHand10K", "train", True, True)])
def test_single_hand_branches_equal_jax(tmp_path, jax_native_built, name,
                                        split, depth, mask):
    records = _single_hand_tree(tmp_path, name, with_depth=depth,
                                with_mask=mask)
    if name == "OneHand10K" and split == "train":
        # distinct dicts (the loader edits each record's paths in place);
        # the train slice [1000:-1000] of 2010 keeps 10
        records = [dict(r) for r in records * 670]
    with open(tmp_path / f"{name}_{split}.pkl", "wb") as f:
        pickle.dump(records, f)
    port, ref = _pair(str(tmp_path), name, split)
    assert len(port) == len(ref) > 0
    for i in range(min(len(ref), 3)):
        _compare(port.__getitem__(i, 1), ref.__getitem__(i, 1))


def _rhd_tree(root):
    """A joints-only RHD tree: (42, 3) landmarks with a confidence column,
    joints from MANO, the 16-bit R/G split depth encoding, label-id masks
    (2-17 left, >= 18 right), one record with an invisible left hand."""
    H = W = 320
    K = np.array([[300.0, 0, 160], [0, 300.0, 160], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(7)
    for sub in ("color", "depth", "mask"):
        os.makedirs(root / "RHD" / "seq" / sub)
    records = []
    for i in range(3):
        joints, lms = [], []
        img = np.full((H, W, 3), 50, np.uint8)
        depth = np.zeros((H, W), np.float32)
        mask = np.zeros((H, W, 3), np.uint8)
        for side, xo in (("left", -0.08), ("right", 0.06)):
            t = lambda a: torch.from_numpy(a.astype(np.float32)[None])
            with torch.no_grad():
                v, j = mano.mano_forward(
                    mano.load_mano_consts(side, device="cpu"),
                    t(rng.uniform(-0.3, 0.3, 3)), t(rng.uniform(-0.2, 0.2, 45)),
                    t(np.zeros(10)), trans=t(np.array([xo, 0.0, 0.6])))
            v, j = v[0].numpy(), j[0].numpy()
            pj = j @ K.T
            conf = np.ones((21, 1), np.float32)
            if i == 2 and side == "left":
                conf[:] = 0.0                 # fewer than 11 visible
            joints.append(j)
            lms.append(np.concatenate([pj[:, :2] / pj[:, 2:], conf], 1))
            pv = v @ K.T
            uv = (pv[:, :2] / pv[:, 2:]).astype(int)
            ok = ((uv >= 2) & (uv < W - 2)).all(1)
            for (x, y), z in zip(uv[ok], v[ok, 2]):
                depth[y - 2:y + 3, x - 2:x + 3] = z
                mask[y - 2:y + 3, x - 2:x + 3, 0] = 5 if side == "left" else 20
                img[y - 2:y + 3, x - 2:x + 3] = (170, 150, 120)
        code = np.round(depth / 5.0 * (2 ** 16 - 1)).astype(np.int64)
        enc = np.zeros((H, W, 3), np.uint8)
        enc[..., 2], enc[..., 1] = code // 256, code % 256
        name = f"{i:05d}.png"
        cv2.imwrite(str(root / "RHD" / "seq" / "color" / name), img)
        cv2.imwrite(str(root / "RHD" / "seq" / "depth" / name), enc)
        cv2.imwrite(str(root / "RHD" / "seq" / "mask" / name), mask)
        records.append({"imgpath": f"seq/color/{name}",
                        "depthpath": f"seq/depth/{name}",
                        "lms": np.concatenate(lms).astype(np.float32),
                        "joints": np.concatenate(joints).astype(np.float32),
                        "K": K})
    for split in ("train", "test"):
        with open(root / f"RHD_{split}.pkl", "wb") as f:
            pickle.dump(records, f)
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_rhd_equals_jax(tmp_path, jax_native_built, split):
    port, ref = _pair(_rhd_tree(tmp_path), "RHD", split)
    for i in range(3):
        got, want = port.__getitem__(i, 2), ref.__getitem__(i, 2)
        _compare(got, want)
        assert "verts_left_gt" not in got
    assert port.__getitem__(2, 0)["valid"].sum() <= 1


def test_numpy_paths_equal_jax(h2o_tree, monkeypatch):
    """Both packages' numpy sampler and splat (the port's ``native=False``,
    the JAX package without its library)."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    kw = dict(cache_path=h2o_tree, pre_fix=h2o_tree, sample_num=256,
              default_resolution=64)
    port = H2ODataset(Config(**kw), "train", native=False)
    ref = JaxDataset(JaxConfig(**kw), "train")
    for i in range(3):
        _compare(port.__getitem__(i, 1), ref.__getitem__(i, 1))


def test_mano_caches_are_separate(h2o_tree):
    """Each package writes and reads its own MANO-GT cache in a shared
    cache_path; the port's carries ``_torch`` and is what it reads."""
    port, ref = _pair(h2o_tree, "H2O", "train")
    names = sorted(n for n in os.listdir(h2o_tree)
                   if n.startswith("H2O_train_manogt_"))
    torch_files = [n for n in names if n.endswith(("_torch_verts.npy",
                                                   "_torch_joints.npy"))]
    assert len(torch_files) == 2 and len(names) == 4, names
    assert port._mano_gt["verts"].filename.endswith("_torch_verts.npy")
    np.testing.assert_allclose(port._mano_gt["verts"], ref._mano_gt["verts"],
                               **MANO_TOL)


def test_batches_and_build_dataset(h2o_tree):
    """The loader over the dataset: the train split drops its tail, the
    test split pads it and marks it (``pad_mask``)."""
    cfg = Config(cache_path=h2o_tree, pre_fix=h2o_tree, sample_num=256,
                 default_resolution=64, num_workers=2)
    train = list(build_dataset(cfg, "train").batches(2, 0))
    test = list(build_dataset(cfg, "test").batches(2, 0))
    assert len(train) == 1 and "pad_mask" not in train[0]
    assert len(test) == 2
    np.testing.assert_array_equal(test[1]["pad_mask"], [1.0, 0.0])
    assert test[0]["id"].tolist() == [1, 1]
    assert test[1]["frame_num"].tolist() == [2, 2]


@pytest.mark.parametrize("split,epoch,variant", [
    ("train", 0, dict(sample_strategy="FPS")),
    ("test", 0, dict(input_feature_num=6)),
    ("train", 3, dict(sample_strategy="FPS", input_feature_num=6)),
    ("test", 0, dict(sample_strategy="FPS", input_feature_num=6,
                     deterministic_cloud_sampling=True))])
def test_normals_and_fps_equal_jax(h2o_tree, jax_native_built, split, epoch,
                                   variant):
    """Clouds with normals (the C++ sampler's, or the deterministic numpy
    one's, with the plane-fit normals appended) and the host FPS
    reordering, whose start points are drawn from the sample's stream after
    both hands are sampled: the same keys as ``test_h2o_equals_jax``.  At
    the default 384x384 the fixture's hands have enough depth pixels to be
    valid (at 64x64 they have not)."""
    kw = dict(cache_path=h2o_tree, pre_fix=h2o_tree, sample_num=256,
              sample_num_level1=128, sample_num_level2=32, **variant)
    port = H2ODataset(Config(**kw), split)
    ref = JaxDataset(JaxConfig(**kw), split)
    hands = 0
    for i in range(len(ref)):
        got, want = port.__getitem__(i, epoch), ref.__getitem__(i, epoch)
        _compare(got, want)
        assert got["cloud"].shape == (2, 256,
                                      variant.get("input_feature_num", 3))
        hands += int(want["valid"].sum())
    assert hands > 0
