"""The port's train-path grouping (``pdfnet_tpu_torch.ops.grouping``) against
the JAX fused grouping with its Pallas kernels in interpret mode.

On CPU tensors the port's wrappers run their plain PyTorch versions, so these
tests hold the plain versions (which ``chip_smoke.py`` in turn holds the CUDA
kernels to, on the card) to the TPU kernels' semantics:

- forward: ``knn_group_xyz`` and ``group_feat`` give the same dist, idx and
  rows as ``knn_gather_xyz_pallas`` and ``group_feat_pallas``, and
  ``group_points``/``group_points_level2`` the same grouped tensors as
  ``_fused_group_pallas``/``_fused_group_feat_pallas``, bit for bit, with
  ties planted (a dyadic grid on which every distance is exact) and points
  exactly on the radius;
- backward: the autograd functions against ``jax.vjp`` of the JAX custom
  VJPs with one seeded cotangent, within 1e-6 of the gradient's largest
  entry (the same sums in another order: scatter_add_ against a one-hot
  matmul).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.ops import grouping as jax_grouping
from pdfnet_tpu.ops.pallas_knn import group_feat_pallas, knn_gather_xyz_pallas

from pdfnet_tpu_torch.ops import grouping
from test_torch_threads import one_torch_thread  # noqa: F401

H, N, S, K = 2, 256, 128, 8
R1, R2 = 0.015, 0.04
ON_RADIUS = 1.0 / 64           # d2 of the planted row S+1 from center 0
BWD_TOL = 1e-6


@pytest.fixture
def interpret():
    """The JAX fused grouping branches with the Pallas kernels in interpret
    mode, as the JAX package's own CPU tests run them."""
    old = jax_grouping._FUSED_INTERPRET
    jax_grouping._FUSED_INTERPRET = True
    try:
        yield
    finally:
        jax_grouping._FUSED_INTERPRET = old


def _grid_points(seed, n=N):
    """Points on a 1/32 grid in [-1/8, 1/8]^3: every difference and squared
    distance is exact in float32, so equal distances are exact ties.  Center
    0 sits apart at (1/2, 1/2, 1/2), its nearest rows are row S+1 at d2 =
    1/64 (on ON_RADIUS) and row S+2 just outside it."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-4, 5, (H, n, 3)).astype(np.float32) / 32.0
    x[:, 0] = 0.5
    x[:, S + 1] = x[:, 0] + np.float32([0.125, 0, 0])
    x[:, S + 2] = x[:, 0] + np.float32([0.125 + 2 ** -20, 0, 0])
    return x


def _feat(seed, c=128):
    """131-wide level-2 rows: grid xyz leading, random features."""
    rng = np.random.RandomState(seed + 100)
    return np.concatenate([_grid_points(seed),
                           rng.randn(H, N, c).astype(np.float32)], -1)


def _cotangent(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_close_to_scale(got, want, tol=BWD_TOL):
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


# ---- forward ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_knn_group_xyz_matches_pallas(seed):
    pts = _grid_points(seed)
    dist_j, idx_j, nbr_j = knn_gather_xyz_pallas(
        jnp.asarray(pts[:, :S]), jnp.asarray(pts), k=K, interpret=True)
    dist_t, idx_t, nbr_t = grouping.knn_group_xyz(torch.from_numpy(pts), S, K)
    d = np.asarray(dist_j)
    assert (d[..., 1:] == d[..., :-1]).any(), "no ties planted"
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(dist_t.numpy(), d)
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))


@pytest.mark.parametrize("radius2", [R1, ON_RADIUS])
def test_group_points_matches_fused_pallas(interpret, radius2):
    """Level 1: centered neighbour xyz, zero out of the ball."""
    pts = _grid_points(2)
    g_j = jax_grouping._fused_group_pallas(jnp.asarray(pts), K, S, radius2)
    g_t, c_t = grouping.group_points(torch.from_numpy(pts), K, S, radius2)
    if radius2 == ON_RADIUS:     # the planted rows straddle the radius
        dist, idx, _ = grouping.knn_group_xyz(torch.from_numpy(pts), S, K)
        assert (idx[:, 0, 1] == S + 1).all() and (idx[:, 0, 2] == S + 2).all()
        assert (dist[:, 0, 1] == radius2).all()
        assert (g_t[:, 0, 1] != 0).any() and (g_t[:, 0, 2] == 0).all()
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(c_t.numpy(), pts[:, :S])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_feat_matches_pallas(dtype):
    """Level 2: grouped rows, idx and valid (dist <= r2) as
    ``group_feat_pallas`` returns them; bf16 rows give bf16-rounded xyz to
    the distances on both sides."""
    feat = _feat(3)
    g_j, idx_j, valid_j = group_feat_pallas(jnp.asarray(feat).astype(dtype),
                                            k=K, num_centers=S,
                                            radius2=ON_RADIUS, interpret=True)
    ft = torch.from_numpy(feat).to(getattr(torch, dtype))
    g_t, idx_t, dist_t = grouping.group_feat(ft, S, K, ON_RADIUS)
    assert g_t.dtype == ft.dtype and dist_t.dtype == torch.float32
    np.testing.assert_array_equal(g_t.float().numpy(),
                                  np.asarray(g_j.astype(jnp.float32)))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal((dist_t <= ON_RADIUS).numpy(),
                                  np.asarray(valid_j))
    assert np.asarray(valid_j).any() and not np.asarray(valid_j).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_points_level2_matches_fused_pallas(interpret, dtype):
    """float32: ``_fused_group_feat_pallas`` in interpret mode; bf16: the
    rows cast to bf16 first, as ``_fused_group_feat_fwd`` does on the TPU,
    and the result cast back to the input's float32."""
    feat = _feat(4)
    fj = jnp.asarray(feat)
    if dtype == "float32":
        g_j = jax_grouping._fused_group_feat_pallas(fj, K, S, R2)
    else:
        g_j = group_feat_pallas(fj.astype(jnp.bfloat16), k=K, num_centers=S,
                                radius2=R2, interpret=True)[0]
        g_j = g_j.astype(jnp.float32)
    g_t, c_t = grouping.group_points_level2(torch.from_numpy(feat), S, K, R2,
                                            getattr(torch, dtype))
    assert g_t.dtype == torch.float32
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(c_t.numpy(), feat[:, :S, :3])


# ---- backward --------------------------------------------------------------

@pytest.mark.parametrize("radius2", [R1, ON_RADIUS])
def test_group_points_backward_matches_jax_vjp(interpret, radius2):
    """Both outputs of ``group_points`` (grouped and centers) carry a
    cotangent, as in the model."""
    pts = _grid_points(5)
    fn = lambda p: jax_grouping.group_points(p, k=K, num_centers=S,
                                             radius2=radius2,
                                             knn_method="pallas_fused")
    (g_j, c_j), vjp = jax.vjp(fn, jnp.asarray(pts))
    cot_g = _cotangent(g_j.shape, 6)
    cot_c = _cotangent(c_j.shape, 7)
    (want,) = vjp((jnp.asarray(cot_g), jnp.asarray(cot_c)))

    x = torch.from_numpy(pts).requires_grad_(True)
    g_t, c_t = grouping.group_points(x, K, S, radius2)
    (got,) = torch.autograd.grad((g_t, c_t), x, (torch.from_numpy(cot_g),
                                                 torch.from_numpy(cot_c)))
    _assert_close_to_scale(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("radius2", [R2, ON_RADIUS])
def test_group_points_level2_backward_matches_jax_vjp(interpret, radius2):
    """Valid cotangents scattered to their rows, minus their sum on the
    centers' xyz; the invalid ones' feature channels to the centers."""
    feat = _feat(8)
    fn = lambda f: jax_grouping.group_points_level2(
        f, num_centers=S, k=K, radius2=radius2, knn_method="pallas_fused")
    (g_j, c_j), vjp = jax.vjp(fn, jnp.asarray(feat))
    cot_g = _cotangent(g_j.shape, 9)
    cot_c = _cotangent(c_j.shape, 10)
    (want,) = vjp((jnp.asarray(cot_g), jnp.asarray(cot_c)))

    x = torch.from_numpy(feat).requires_grad_(True)
    g_t, c_t = grouping.group_points_level2(x, S, K, radius2, torch.float32)
    valid = grouping.group_feat(x.detach(), S, K, radius2)[2] <= radius2
    assert valid.any() and not valid.all()
    (got,) = torch.autograd.grad((g_t, c_t), x, (torch.from_numpy(cot_g),
                                                 torch.from_numpy(cot_c)))
    _assert_close_to_scale(got.numpy(), np.asarray(want))


def test_non_finite_points_rank_after_every_finite_one():
    """The order the kernels are held to on a non-finite cloud (what
    ``skip_nonfinite_updates`` guards against): NaN distances after +inf,
    equal keys by index, so every selected index is a row of the hand."""
    pts = _grid_points(0)
    pts[0, 10:20] = np.nan
    pts[1, 3] = np.inf
    dist, idx, _ = grouping.knn_group_xyz(torch.from_numpy(pts), S, K)
    assert ((idx >= 0) & (idx < N)).all()
    np.testing.assert_array_equal(idx[0, 10].numpy(), np.arange(K))
    finite = torch.isfinite(dist[:, :, :-1])
    assert not (torch.isnan(dist[:, :, :-1]) & torch.isfinite(dist[:, :, 1:])
                ).any()
    assert finite[0, 0].all() and not (idx[0, 0] == 15).any()


def test_cpu_grouping_launches_no_kernel():
    """On CPU tensors the wrappers run their plain versions only."""
    grouping.reset_launches()
    pts = torch.from_numpy(_grid_points(0))
    grouping.knn_group_xyz(pts, S, K)
    grouping.group_feat(torch.from_numpy(_feat(0)), S, K, R2)
    assert all(v == 0 for v in grouping.launches.values())
