"""Farthest point sampling and the host-side cloud twins of the port against
the JAX package.

- Device FPS (``pdfnet_tpu_torch.ops.fps``) against ``pdfnet_tpu/ops/fps.py``
  (vmapped over the hands): the indices and permutations are equal, on
  continuous random clouds, on wrap-padded clouds (repeated points, so the
  argmax meets exact ties once the farthest distances reach zero) and on
  clouds of all-zero points (the hands the cloud builder zeroes).  Both take
  the first maximum and compute the same float32 squared distances.
- Host twins (``pdfnet_tpu_torch.data.cloud``): numpy on both sides, so
  ``fps_order_host``, ``fps_reorder_cloud``, ``normals_at_indices_np`` and
  ``sample_hand_cloud(with_normals=True)`` give the same bits from the same
  inputs and ``RandomState``, which is left in the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu import native as jax_native
from pdfnet_tpu.data import cloud as jax_cloud
from pdfnet_tpu.ops import fps as jax_fps

from pdfnet_tpu_torch.data import cloud
from pdfnet_tpu_torch.ops import fps
from test_torch_threads import one_torch_thread  # noqa: F401


def _clouds(kind, H=6, N=256, seed=0):
    """(H, N, 3) float32 hands: ``random`` continuous points, ``wrapped``
    (a sparse hand's in-band pixels repeated to N, as the samplers pad),
    ``zeros`` (a hand the cloud builder zeroes)."""
    rng = np.random.RandomState(seed)
    pts = rng.normal(0.0, 0.03, (H, N, 3)).astype(np.float32)
    pts[..., 2] += 0.5
    if kind == "wrapped":
        n = [20, 37, 100, 128, 200, 255][:H]
        pts = np.stack([np.resize(p[:k], (N, 3)) for p, k in zip(pts, n)])
    elif kind == "zeros":
        pts = np.zeros_like(pts)
    return pts


def _jax_order(pts, n1, n2):
    f = jax.vmap(lambda p: jax_fps.fps_two_level_order(p, n1, n2))
    return np.asarray(f(jnp.asarray(pts)))


@pytest.mark.parametrize("kind", ["random", "wrapped", "zeros"])
@pytest.mark.parametrize("first", [0, 7])
def test_farthest_point_sampling_matches_jax(kind, first):
    pts = _clouds(kind)
    want = jax.vmap(lambda p: jax_fps.farthest_point_sampling(p, 128, first))(
        jnp.asarray(pts))
    got = fps.farthest_point_sampling(torch.from_numpy(pts), 128, first)
    assert got.shape == (6, 128) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["random", "wrapped", "zeros"])
def test_prefix_order_matches_jax(kind):
    pts = _clouds(kind)
    want = jax.vmap(lambda p: jax_fps._fps_prefix_order(p, 64))(
        jnp.asarray(pts))
    got = fps._fps_prefix_order(torch.from_numpy(pts), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a permutation, the picks ascending in the prefix
    np.testing.assert_array_equal(np.sort(got.numpy(), axis=1),
                                  np.broadcast_to(np.arange(256), (6, 256)))


@pytest.mark.parametrize("kind,n1,n2", [("random", 128, 32),
                                        ("wrapped", 128, 64),
                                        ("wrapped", 256, 128),
                                        ("zeros", 128, 32)])
def test_two_level_order_matches_jax(kind, n1, n2):
    pts = _clouds(kind)
    got = fps.fps_two_level_order(torch.from_numpy(pts).reshape(2, 3, 256, 3),
                                  n1, n2)
    assert got.shape == (2, 3, 256)
    np.testing.assert_array_equal(got.reshape(6, 256).numpy(),
                                  _jax_order(pts, n1, n2))


def test_fps_reorder_matches_jax():
    """Six channels (xyz + normals) move with their points."""
    rng = np.random.RandomState(1)
    pts = np.concatenate([_clouds("wrapped"), rng.normal(
        size=(6, 256, 3)).astype(np.float32)], axis=-1)
    want = jax.vmap(lambda p: jax_fps.fps_reorder(p, 128, 32))(
        jnp.asarray(pts))
    got = fps.fps_reorder(torch.from_numpy(pts), 128, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fps_spreads_points():
    """``tests/test_ops.py``'s check of the JAX FPS: two arms of a cross,
    both reached by 8 distinct picks."""
    pts = np.zeros((64, 3), np.float32)
    pts[:32, 0] = np.linspace(0, 1, 32)
    pts[32:, 1] = np.linspace(0, 1, 32)
    idx = fps.farthest_point_sampling(torch.from_numpy(pts), 8).numpy()
    assert len(np.unique(idx)) == 8
    sel = pts[idx]
    assert sel[:, 0].max() > 0.9 and sel[:, 1].max() > 0.9


# ---- the host twins --------------------------------------------------------

@pytest.mark.parametrize("kind,num", [("random", 64), ("wrapped", 128),
                                      ("random", 300)])
def test_fps_order_host_bitwise(kind, num):
    pts = _clouds(kind, H=1)[0]
    rng_t, rng_j = np.random.RandomState(5), np.random.RandomState(5)
    got = cloud.fps_order_host(pts, num, rng_t)
    want = jax_cloud.fps_order_host(pts, num, rng_j)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(len(pts)))
    assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)


@pytest.mark.parametrize("kind", ["random", "wrapped"])
def test_fps_reorder_cloud_bitwise(kind):
    rng = np.random.RandomState(2)
    c = np.concatenate([_clouds(kind, H=1)[0],
                        rng.normal(size=(256, 3)).astype(np.float32)], 1)
    choose = rng.randint(0, 64 * 64, 256).astype(np.int64)
    rng_t, rng_j = np.random.RandomState(9), np.random.RandomState(9)
    got = cloud.fps_reorder_cloud(c.copy(), choose.copy(), 128, 32, rng_t)
    want = jax_cloud.fps_reorder_cloud(c.copy(), choose.copy(), 128, 32,
                                       rng_j)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)


def _hand_depth(seed, H=48, W=64, z=0.5):
    """A masked hand depth map: a smooth surface around z with holes,
    touching the image border (zero padding of the neighbourhoods)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    d = z + 0.02 * np.sin(xx / 7.0) + 0.01 * np.cos(yy / 5.0)
    d = d + rng.uniform(-0.002, 0.002, d.shape)
    d[rng.uniform(size=d.shape) < 0.2] = 0.0
    d[:, :W // 4] = 0.0
    K = np.array([[60.0, 0, W / 2], [0, 62.0, H / 2], [0, 0, 1]], np.float32)
    return d.astype(np.float32), K


@pytest.mark.parametrize("z", [0.5, 1.5])
def test_normals_at_indices_bitwise(z):
    depth, K = _hand_depth(3, z=z)
    pts = jax_cloud.backproject_np(depth, K)
    np.testing.assert_array_equal(cloud.backproject_np(depth, K), pts)
    idx = np.random.RandomState(4).choice(depth.size, 300, replace=False)
    idx[:3] = [0, depth.shape[1] - 1, depth.size - 1]       # the corners
    got = cloud.normals_at_indices_np(pts, idx)
    np.testing.assert_array_equal(got, jax_cloud.normals_at_indices_np(pts,
                                                                       idx))
    assert got.dtype == np.float32


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
def test_sample_hand_cloud_with_normals_bitwise(native, deterministic,
                                                monkeypatch):
    """The numpy sampler and the C++ one (``native``), each with the
    normals appended, and the invalid hand's six zero channels."""
    if native and not jax_native.available():
        pytest.skip("the JAX package's native library did not build")
    monkeypatch.setattr(jax_native, "available", lambda: native)
    depth, K = _hand_depth(6)
    for d, n in ((depth, 256), (depth, 2048), (np.zeros_like(depth), 256)):
        rng_t, rng_j = np.random.RandomState(1), np.random.RandomState(1)
        ct, xt, okt = cloud.sample_hand_cloud(d, K, n, rng_t, native=native,
                                              deterministic=deterministic,
                                              with_normals=True)
        cj, xj, okj = jax_cloud.sample_hand_cloud(
            d, K, n, rng_j, use_native=native, deterministic=deterministic,
            with_normals=True)
        assert okt == okj and xt.shape == (n, 6) and xt.dtype == xj.dtype
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(xt, xj)
        assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)
