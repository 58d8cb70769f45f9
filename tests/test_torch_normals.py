"""The port's surface normals (``pdfnet_tpu_torch.ops.geometry``,
``ops.pointcloud.normals_at``) against the JAX package's
``backproject_depth`` and ``depth_normals`` and the numpy twin
``data/cloud.normals_at_indices_np``.

The plane fit solves (A^T A) n = A^T 1 over a 5x5 dilation-2 neighbourhood,
and solves against the identity where det(A^T A) < 1e-5: the "normal" is
then the normalized sum of the 25 neighbours.  At the hand's depths and
intrinsics (H2O's: 0.4-0.8 m at f ~ 636 px) det is 1e-8..2e-6, so the
guard is taken and the normals agree with JAX's within 1e-5 (float32 sums
of 25 points in another order).

Where the solve is taken (a short focal length or a far hand), A^T A has a
condition number of ~1e4..1e5, so float32 rounding of its sums in another
order moves the solution by up to ~5e-4: those normals are held to JAX's at
2e-3, the tolerance of the JAX package's own host-against-device check
(``tests/test_ops.py:test_host_normals_match_device_twin``).  Near
det = 1e-5 (about 1.05 m at H2O's intrinsics) a last-bit difference flips
the branch; ``test_guard_flips_are_counted`` counts those points on a
depth ramp that crosses it and holds every other point to its branch's
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.data import cloud as jax_cloud
from pdfnet_tpu.ops import geometry as jax_geometry

from pdfnet_tpu_torch.ops import geometry
from pdfnet_tpu_torch.ops.pointcloud import normals_at
from test_torch_threads import one_torch_thread  # noqa: F401

H2O_K = np.array([[636.6593, 0.0, 64.0], [0.0, 636.2520, 48.0], [0, 0, 1]],
                 np.float32)
GUARDED_TOL = 1e-5
SOLVED_TOL = 2e-3


def _depth(seed, z0, z1, H=96, W=128, holes=0.2):
    """A smooth hand-like surface from depth z0 (left) to z1 (right) with
    small bumps, holes (masked-out pixels) and a zero band at the left
    border."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    d = z0 + (z1 - z0) * xx / (W - 1) + 0.004 * np.sin(xx / 5.0) \
        + 0.003 * np.cos(yy / 4.0) + rng.uniform(-5e-4, 5e-4, (H, W))
    d[rng.uniform(size=d.shape) < holes] = 0.0
    d[:, :6] = 0.0
    return d.astype(np.float32)


def _jax(depth, K_inv):
    pts = jax_geometry.backproject_depth(jnp.asarray(depth),
                                         jnp.asarray(K_inv))
    return np.asarray(pts), np.asarray(jax_geometry.depth_normals(pts))


def _port(depth, K_inv):
    pts = geometry.backproject_depth(torch.from_numpy(depth),
                                     torch.from_numpy(K_inv))
    return pts, geometry.depth_normals(pts)


def _det(points):
    """det(A^T A) of every pixel's neighbourhood, in float64 (which branch
    the exact arithmetic would take)."""
    nb = torch.stack([geometry._shifted(points, dy, dx)
                      for dy in geometry.NORMAL_OFFSETS
                      for dx in geometry.NORMAL_OFFSETS], dim=-2).double()
    return torch.linalg.det(torch.einsum("...ki,...kj->...ij", nb, nb)).numpy()


@pytest.mark.parametrize("z0,z1", [(0.4, 0.5), (0.6, 0.8)])
def test_depth_normals_match_jax_at_hand_depth(z0, z1):
    depth = _depth(0, z0, z1)
    K_inv = np.linalg.inv(H2O_K).astype(np.float32)
    pts_j, n_j = _jax(depth, K_inv)
    pts_t, n_t = _port(depth, K_inv)
    np.testing.assert_allclose(pts_t.numpy(), pts_j, rtol=1e-6, atol=1e-7)
    assert (_det(pts_t) < 1e-5 * 0.5).all()       # all guarded, far from it
    assert n_t.shape == (96, 128, 3)
    np.testing.assert_allclose(n_t.numpy(), n_j, atol=GUARDED_TOL)
    hand = depth > 0
    np.testing.assert_allclose(np.linalg.norm(n_t.numpy()[hand], axis=-1),
                               1.0, atol=1e-6)


def test_depth_normals_match_jax_where_solved():
    """A short focal length: det(A^T A) >= 1e-5 on most pixels."""
    depth = _depth(1, 0.45, 0.55, H=48, W=64)
    K = np.array([[60.0, 0, 32], [0, 62.0, 24], [0, 0, 1]], np.float32)
    K_inv = np.linalg.inv(K).astype(np.float32)
    pts_j, n_j = _jax(depth, K_inv)
    pts_t, n_t = _port(depth, K_inv)
    det = _det(pts_t)
    solved = det >= 2e-5
    assert solved.mean() > 0.5
    err = np.abs(n_t.numpy() - n_j).max(-1)
    assert err[solved].max() <= SOLVED_TOL
    assert err[det < 0.5e-5].max() <= GUARDED_TOL


def test_normals_at_equal_the_full_map():
    """At the chosen pixels only, bit for bit the full map's values, the
    image corners included; and the numpy twin's within the branch
    tolerances (every pixel here is guarded)."""
    depth = _depth(2, 0.5, 0.7)
    K_inv = np.linalg.inv(H2O_K).astype(np.float32)
    pts, full = _port(depth, K_inv)
    rng = np.random.RandomState(3)
    idx = rng.choice(depth.size, (2, 3, 200))
    idx[..., 0], idx[..., 1] = 0, depth.size - 1
    d = torch.from_numpy(np.broadcast_to(depth, (2, 3) + depth.shape).copy())
    got = normals_at(d, torch.from_numpy(idx),
                     torch.from_numpy(np.broadcast_to(K_inv, (2, 3, 3, 3))
                                      .copy()))
    assert got.shape == (2, 3, 200, 3)
    torch.testing.assert_close(got, full.reshape(-1, 3)[idx], rtol=0, atol=0)
    host = jax_cloud.normals_at_indices_np(
        jax_cloud.backproject_np(depth, H2O_K), idx.reshape(-1))
    np.testing.assert_allclose(got.reshape(-1, 3).numpy(), host,
                               atol=GUARDED_TOL)


def test_guard_flips_are_counted():
    """A ramp from 0.95 to 1.15 m at H2O's intrinsics crosses det = 1e-5:
    where the port and JAX take the same branch, the normals agree within
    that branch's tolerance; the flipped points lie within rounding of the
    threshold and are few."""
    depth = _depth(4, 0.95, 1.15, holes=0.0)
    K_inv = np.linalg.inv(H2O_K).astype(np.float32)
    pts_j, n_j = _jax(depth, K_inv)
    pts_t, n_t = _port(depth, K_inv)
    nb = jnp.stack([jax_geometry._shifted(jnp.asarray(pts_j), dy, dx)
                    for dy in (-4, -2, 0, 2, 4) for dx in (-4, -2, 0, 2, 4)],
                   axis=-2)
    det_j = np.asarray(jnp.linalg.det(jnp.einsum("...ki,...kj->...ij", nb, nb,
                                                 precision="highest")))
    nb_t = torch.stack([geometry._shifted(pts_t, dy, dx)
                        for dy in geometry.NORMAL_OFFSETS
                        for dx in geometry.NORMAL_OFFSETS], dim=-2)
    det_t = torch.linalg.det(torch.einsum("...ki,...kj->...ij", nb_t,
                                          nb_t)).numpy()
    guard_t, guard_j = det_t < 1e-5, det_j < 1e-5
    flips = guard_t != guard_j
    inner = depth > 0
    assert guard_t[inner].any() and (~guard_t[inner]).any()   # it crosses
    print(f"det guard: {flips.sum()} of {flips.size} pixels take the other "
          f"branch than JAX's")
    assert flips.mean() < 0.01
    assert np.all(np.abs(det_t[flips] - 1e-5) < 1e-7)
    err = np.abs(n_t.numpy() - n_j).max(-1)
    assert err[guard_t & guard_j].max() <= GUARDED_TOL
    assert err[~guard_t & ~guard_j].max() <= SOLVED_TOL


def test_fronto_parallel_plane():
    """``tests/test_ops.py``'s check of the JAX normals: a plane facing the
    camera has normals along z away from the zero-padded border."""
    K = np.array([[100.0, 0, 16], [0, 100.0, 16], [0, 0, 1]], np.float32)
    depth = torch.full((32, 32), 0.5)
    n = geometry.depth_normals(geometry.backproject_depth(
        depth, torch.from_numpy(np.linalg.inv(K)))).numpy()
    assert np.all(np.abs(n[8:-8, 8:-8, 2]) > 0.99)
