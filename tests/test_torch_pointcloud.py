"""The port's device-side cloud builder (``pdfnet_tpu_torch.ops.pointcloud``)
against the JAX one (``pdfnet_tpu/ops/pointcloud.py``).

Deterministic mode takes the first N in-band pixels in ascending flat
order, wrap-padded, on both sides: ``choose`` and ``ok`` must be identical
and the cloud within 1e-6 of its scale (``K^-1`` and the ray sums in
another order).  The depths sit on a 1 mm grid and no mask value lies
within 1e-3 of 0.5, so no pixel is on a threshold; the hands cover a dense
hand (more in-band pixels than N, with out-of-range and out-of-band depths
among them), a sparse one (wrap padding), one under ``MIN_PIXELS`` and one
marked not valid.

``with_normals`` and ``fps_levels`` are compared in deterministic mode, as
the cloud they start from.

Random mode draws its priorities from a ``torch.Generator`` and takes an
exact top-N, where JAX takes ``lax.approx_max_k`` of ``jax.random``
priorities: the two agree in distribution only, so the test checks the
properties (in band, no duplicates when there are at least N pixels, the
same generator seed gives the same cloud).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.ops import pointcloud as jax_pointcloud

from pdfnet_tpu_torch.ops import pointcloud
from test_torch_threads import one_torch_thread  # noqa: F401

B, HW, NPTS = 2, 32, 64


def _scene(seed=0):
    """depth (B, HW, HW), mask (B, HW, HW, 2) [left, right], K (B, 3, 3),
    valid (B, 2).  Sample 0: a dense left hand and a sparse right one (20
    pixels: wrap padding); sample 1: a left hand of 6 pixels (under
    MIN_PIXELS) and a dense right hand marked not valid."""
    rng = np.random.RandomState(seed)
    depth = np.round(rng.uniform(0.3, 0.8, (B, HW, HW)) * 1000) / 1000
    mask = rng.uniform(0.0, 0.49, (B, HW, HW, 2))
    regions = {(0, 0): (slice(4, 20), slice(6, 22)),
               (0, 1): (slice(24, 28), slice(2, 7)),
               (1, 0): (slice(10, 12), slice(10, 13)),
               (1, 1): (slice(8, 24), slice(8, 24))}
    for (b, h), (rows, cols) in regions.items():
        mask[b, rows, cols, h] = rng.uniform(0.51, 1.0, mask[b, rows, cols,
                                                              h].shape)
        # a hand at ~0.5 m, with one depth out of [Z_MIN, Z_MAX] and one
        # inside it but out of the band around the hand's mean
        depth[b, rows, cols] = np.round(
            rng.uniform(0.46, 0.54, depth[b, rows, cols].shape) * 1000) / 1000
        depth[b, rows.start, cols.start] = 3.0
        depth[b, rows.start, cols.start + 1] = 0.7
    K = np.stack([np.array([[400.0 + 10 * b, 0, HW / 2 + b],
                            [0, 410.0 - 5 * b, HW / 2 - b],
                            [0, 0, 1]]) for b in range(B)])
    valid = np.array([[1.0, 1.0], [1.0, 0.0]])
    f32 = lambda a: a.astype(np.float32)
    return f32(depth), f32(mask), f32(K), f32(valid)


def _port(scene, **kw):
    return pointcloud.depth_to_hand_clouds(*map(torch.from_numpy, scene),
                                           num_points=NPTS, **kw)


def test_deterministic_clouds_match_jax():
    scene = _scene()
    assert np.abs(scene[1] - 0.5).min() > 1e-3
    choose_j, cloud_j, ok_j = jax_pointcloud.depth_to_hand_clouds(
        *map(jnp.asarray, scene), jax.random.PRNGKey(0), num_points=NPTS,
        deterministic=True)
    choose_t, cloud_t, ok_t = _port(scene, deterministic=True)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(ok_t.numpy(), [[True, True],
                                                 [False, False]])
    np.testing.assert_array_equal(choose_t.numpy(), np.asarray(choose_j))
    cj = np.asarray(cloud_j)
    assert cloud_t.dtype == torch.float32 and cloud_t.shape == cj.shape
    assert np.abs(cloud_t.numpy() - cj).max() <= 1e-6 * np.abs(cj).max()

    # the sparse hand wraps its in-band pixels; the others are all zero
    sparse = choose_t[0, 1].numpy()
    n = len(np.unique(sparse))
    assert 10 <= n < NPTS
    np.testing.assert_array_equal(sparse, np.resize(sparse[:n], NPTS))
    assert (choose_t[1] == 0).all() and (cloud_t[1] == 0).all()


def test_random_clouds_have_the_sampler_properties():
    depth, mask, K, valid = scene = _scene(1)
    clouds = [_port(scene, generator=torch.Generator().manual_seed(s))
              for s in (0, 0, 1)]
    (choose, cloud, ok), same, other = clouds
    assert torch.equal(choose, same[0]) and torch.equal(cloud, same[1])
    assert not torch.equal(choose, other[0])
    np.testing.assert_array_equal(ok.numpy(), [[True, True], [False, False]])

    flat_d = depth.reshape(B, -1)
    for h, dense in ((0, True), (1, False)):
        c = choose[0, h].numpy()
        m = mask[0, ..., h].reshape(-1) > 0.5
        assert m[c].all(), "a chosen pixel outside the hand's mask"
        z = flat_d[0][m]
        z = z[(z > pointcloud.Z_MIN) & (z < pointcloud.Z_MAX)]
        lo = max(pointcloud.Z_MIN, z.mean() - pointcloud.BAND)
        hi = min(pointcloud.Z_MAX, z.mean() + pointcloud.BAND)
        assert ((flat_d[0][c] > lo) & (flat_d[0][c] < hi)).all()
        if dense:
            assert len(np.unique(c)) == NPTS, "duplicates in a dense hand"
        else:
            assert len(np.unique(c)) == int(((flat_d[0][m] > lo)
                                             & (flat_d[0][m] < hi)).sum())
    # the cloud is the back-projection of the chosen pixels
    u, v = choose % HW, choose // HW
    rays = torch.einsum("bij,bhnj->bhni", torch.linalg.inv(torch.from_numpy(K)),
                        torch.stack([u, v, torch.ones_like(u)], -1).float())
    z = torch.from_numpy(depth).reshape(B, 1, -1).expand(B, 2, -1)
    want = rays * torch.gather(z, 2, choose)[..., None]
    want = torch.where(ok[..., None, None], want, 0.0)
    torch.testing.assert_close(cloud, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_normals,fps_levels", [
    (True, None), (False, (32, 16)), (True, (32, 16)), (True, (64, 64))])
def test_normals_and_fps_match_jax(seed, with_normals, fps_levels):
    """``with_normals`` (xyz + the normals of each hand's masked depth) and
    ``fps_levels`` (two-level FPS of each hand, the zeroed hands included)
    in deterministic mode: ``choose`` and ``ok`` identical, the cloud within
    1e-5 (every point's det(A^T A) is far under the guard's 1e-5 here, so
    the normals are normalized neighbour sums: float32 sums in another
    order)."""
    scene = _scene(seed)
    kw = dict(with_normals=with_normals, fps_levels=fps_levels)
    choose_j, cloud_j, ok_j = jax_pointcloud.depth_to_hand_clouds(
        *map(jnp.asarray, scene), jax.random.PRNGKey(0), num_points=NPTS,
        deterministic=True, **kw)
    choose_t, cloud_t, ok_t = _port(scene, deterministic=True, **kw)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(choose_t.numpy(), np.asarray(choose_j))
    cj = np.asarray(cloud_j)
    assert cloud_t.shape == cj.shape == (B, 2, NPTS, 6 if with_normals else 3)
    np.testing.assert_allclose(cloud_t.numpy(), cj, rtol=0, atol=1e-5)
    if with_normals:
        n = np.linalg.norm(cloud_t[..., 3:].numpy(), axis=-1)
        np.testing.assert_allclose(n[ok_t.numpy()], 1.0, atol=1e-6)


def test_clouds_stay_float32_under_autocast():
    """The model builds its clouds inside its bf16 autocast region: the
    normals' plane fit (an einsum, which autocast would run in bf16) and
    the FPS order are the float32 ones."""
    scene = _scene()
    kw = dict(deterministic=True, with_normals=True, fps_levels=(32, 16))
    want = _port(scene, **kw)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = _port(scene, **kw)
    assert got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
