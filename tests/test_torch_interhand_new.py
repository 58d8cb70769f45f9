"""The port's InterHandNew dataset (``pdfnet_tpu_torch.data.interhand_new``)
against the JAX package's, key by key, on the fixture tree of
``tests/test_interhand_new.py`` (its test split, and a train split made
here by copying it: flip, brightness, scale, center jitter and rotation
drawn per sample and epoch).

Both packages draw every random choice from the same numpy stream, so every
key equal bit for bit but the MANO-derived ones (3-D vertices and joints,
their projections, and the CenterNet sizes and offsets from the projected
joints), which agree within 1e-5: the two MANO layers agree to float32
rounding.  The clouds are zero and (2, N, 3) whatever
``input_feature_num`` says, as the JAX dataset returns them (RGB-only
records).
"""

import shutil

import numpy as np
import pytest

from pdfnet_tpu import native as jax_native
from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.data.interhand_new import InterHandNewDataset as JaxDataset

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data.interhand_new import InterHandNewDataset

from test_interhand_new import ihn_tree  # noqa: F401  (fixture reuse)
from test_torch_threads import one_torch_thread  # noqa: F401

MANO_KEYS = ("verts_left_gt", "verts_right_gt", "verts2d_left_gt",
             "verts2d_right_gt", "joints_left_gt", "joints_right_gt",
             "lms_left_gt", "lms_right_gt", "wh", "off_hm", "off_lms")
MANO_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tree(ihn_tree):  # noqa: F811
    """The fixture's test split, copied to a train split as well."""
    base = f"{ihn_tree}/InterHandNew"
    shutil.copytree(f"{base}/test", f"{base}/train")
    return ihn_tree


def _pair(root, split, native=True, **kw):
    kw = dict(dataset="InterHandNew", cache_path=root, default_resolution=128,
              sample_num=64, **kw)
    return (InterHandNewDataset(Config(**kw), split, native=native),
            JaxDataset(JaxConfig(**kw), split))


def _compare(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in MANO_KEYS:
            np.testing.assert_allclose(g, w, err_msg=k, **MANO_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("split,epoch", [("test", 0), ("train", 0),
                                         ("train", 1), ("train_3d", 2)])
def test_samples_equal_jax(tree, split, epoch):
    port, ref = _pair(tree, split)
    assert len(port) == len(ref) == 2
    for i in range(len(ref)):
        _compare(port.__getitem__(i, epoch), ref.__getitem__(i, epoch))


def test_numpy_heatmaps_equal_jax(tree, monkeypatch):
    """The numpy splat on both sides (``native=False``; the JAX package's
    library patched away)."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    port, ref = _pair(tree, "train", native=False)
    for i in range(len(ref)):
        _compare(port.__getitem__(i, 3), ref.__getitem__(i, 3))


@pytest.mark.parametrize("variant", [dict(input_feature_num=6),
                                     dict(sample_strategy="FPS")])
def test_clouds_stay_xyz_zeros(tree, variant):
    """The RGB-only records' zero clouds keep three channels at
    ``input_feature_num=6``, in both packages."""
    port, ref = _pair(tree, "test", **variant)
    got, want = port[0], ref[0]
    _compare(got, want)
    assert got["cloud"].shape == (2, 64, 3) and not got["cloud"].any()


@pytest.mark.parametrize("split", ["train", "test"])
def test_batches_equal_jax(tree, split):
    """``batches``: the train split shuffled by the epoch's seed with its
    tail dropped, the test split in order with its tail padded and
    masked."""
    port, ref = _pair(tree, split)
    got, want = (list(d.batches(1 if split == "train" else 3, epoch=1))
                 for d in (port, ref))
    assert len(got) == len(want) == (2 if split == "train" else 1)
    for g, w in zip(got, want):
        _compare(g, w)


def test_missing_split_raises(tree):
    with pytest.raises(FileNotFoundError, match="InterHandNew"):
        InterHandNewDataset(Config(dataset="InterHandNew", cache_path=tree),
                            "val")
