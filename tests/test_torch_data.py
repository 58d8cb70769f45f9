"""The port's host data utilities against the JAX package's:
``data/augment.py`` (equal outputs), ``data/loader.py`` ``iter_batches``
(the same batches in the same order: the permutation, the process striping,
the dropped train tail, the padded eval tail and its ``pad_mask``) and
``data/prefetch.py`` (order, errors, ``close`` releasing the source, and
the end of a source under a slow consumer, where the JAX module's end
marker can be lost).
"""

import threading
import time

import numpy as np
import pytest

from pdfnet_tpu.data import augment as jax_aug
from pdfnet_tpu.data.loader import iter_batches as jax_iter_batches
from pdfnet_tpu.data.prefetch import prefetch as jax_prefetch

from pdfnet_tpu_torch.data import augment as aug
from pdfnet_tpu_torch.data.loader import iter_batches
from pdfnet_tpu_torch.data.prefetch import prefetch
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("rot,shift", [(0, (0.0, 0.0)), (37, (0.1, -0.2)),
                                       (-60, (0.0, 0.05))])
def test_affine_transforms_equal_jax(rot, shift):
    c = np.array([640.3, 355.7], np.float32)
    got = aug.get_affine_transform(c, 1280.0, rot, (384, 384), shift)
    want = jax_aug.get_affine_transform(c, 1280.0, rot, (384, 384), shift)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pts = np.random.RandomState(0).uniform(0, 1280, (42, 2)).astype(np.float32)
    np.testing.assert_array_equal(aug.affine_transform_points(pts, got[0]),
                                  jax_aug.affine_transform_points(pts, want[0]))
    K = np.array([[636.6, 0, 635.3], [0, 636.3, 366.9], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(aug.update_intrinsics(K, got[0]),
                                  jax_aug.update_intrinsics(K, want[0]))
    np.testing.assert_array_equal(
        aug.rotation_point_matrix(got[0], K, rot),
        jax_aug.rotation_point_matrix(want[0], K, rot))


@pytest.mark.parametrize("noise", [0.0, 3.0])
def test_add_noise_equals_jax(noise):
    img = np.random.RandomState(1).randint(0, 256, (32, 48, 3)).astype(np.uint8)
    got = aug.add_noise(img, np.random.RandomState(2), noise=noise)
    want = jax_aug.add_noise(img, np.random.RandomState(2), noise=noise)
    np.testing.assert_array_equal(got, want)


def _fetch(i):
    return {"x": np.full((3,), i, np.float32), "i": np.int64(i),
            "odd": np.int64(i % 2)}


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3),                          # train: drop tail
    dict(shuffle=True, seed=4, workers=3),
    dict(shuffle=False, pad_tail=True),                  # eval: pad tail
    dict(shuffle=True, seed=5, process_index=1, process_count=3),
    dict(shuffle=False, pad_tail=True, process_index=2, process_count=3)])
def test_iter_batches_equal_jax(kw):
    got = list(iter_batches(_fetch, 23, 4, **kw))
    want = list(jax_iter_batches(_fetch, 23, 4, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    if kw.get("pad_tail"):
        assert got[-1]["pad_mask"].sum() < 4
        assert sum(b["pad_mask"].sum() for b in got) == len(
            range(kw.get("process_index", 0), 23, kw.get("process_count", 1)))


def test_iter_batches_keeps_keys_every_sample_has():
    def fetch(i):
        s = _fetch(i)
        if i != 2:
            s["only_some"] = np.int64(1)
        return s
    got = next(iter_batches(fetch, 8, 4, shuffle=False))
    assert "only_some" not in got and set(got) == {"x", "i", "odd"}


def test_prefetch_order_and_errors():
    assert list(prefetch(range(10), depth=3, transform=lambda x: x * 2)) == [
        x * 2 for x in range(10)]

    def bad():
        yield 1
        raise ValueError("boom")

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_close_releases_source():
    closed = []

    def gen():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.append(True)

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    assert closed == [True]
    with pytest.raises(StopIteration):
        next(it)


def _drain_slowly(it, out):
    for x in it:
        time.sleep(0.2)
        out.append(x)
    out.append("end")


@pytest.mark.parametrize("make,ends", [(prefetch, True),
                                       (jax_prefetch, False)])
def test_prefetch_ends_under_a_slow_consumer(make, ends):
    """A source that ends while the queue is full: the port's consumer
    sees every item and the end; the JAX module drops its end marker on the
    full queue, and its consumer blocks once it has drained the queue (the
    fault the port repairs)."""
    out = []
    it = make(iter(range(3)), depth=2)
    t = threading.Thread(target=_drain_slowly, args=(it, out), daemon=True)
    t.start()
    t.join(5.0)
    if ends:
        assert out == [0, 1, 2, "end"]
    else:
        assert out == [0, 1, 2] and t.is_alive()
        it.close()
        it._q.put(it._done)              # release the blocked consumer
        t.join(5.0)
        assert not t.is_alive()
