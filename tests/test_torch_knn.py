"""The port's generic set-abstraction grouping against the JAX one: the
exact kNN selection ``ops.sa.knn`` (the plain version of K5, which
``chip_smoke.py`` holds the CUDA kernel to on the card) against
``knn_pallas`` in interpret mode, and ``knn_method="topk"``/``"pallas"``
through ``knn_ball_query``, ``group_points``/``group_points_level2`` and
``PointNetPlus`` against the JAX generic branch.

Points on a dyadic grid make every distance exact, in the direct form
``(dx*dx + dy*dy) + dz*dz`` and in the matmul expansion alike, so exact
ties are planted and both selections are bit-identical to JAX's.  Off the
grid the JAX ``topk`` branch (which JAX's ``"pallas"`` also takes off the
TPU, ``grouping.py:79-80``) ranks by the expansion, whose rounding can
reorder near ties; the model-level test asserts the selected sets agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.models.pointnet import PointNetPlus as JaxPointNetPlus
from pdfnet_tpu.ops import grouping as jax_grouping
from pdfnet_tpu.ops.pallas_knn import knn_pallas

from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.models.pointnet import PointNetPlus
from pdfnet_tpu_torch.ops import grouping, sa
from test_torch_threads import one_torch_thread  # noqa: F401

H, N, S, K = 2, 256, 128, 8
R1, R2 = 0.015, 0.04
ON_RADIUS = 1.0 / 64           # d2 of the planted row S+1 from center 0
TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = 1e-6
METHODS = ("topk", "pallas")


def _grid_points(seed, n=N):
    """Points on a 1/32 grid in [-1/8, 1/8]^3 (every distance exact, so
    equal distances are exact ties).  Center 0 sits apart at (1/2, 1/2,
    1/2); its nearest rows are row S+1 at d2 = 1/64 (on ON_RADIUS) and row
    S+2 just outside it."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-4, 5, (H, n, 3)).astype(np.float32) / 32.0
    x[:, 0] = 0.5
    x[:, S + 1] = x[:, 0] + np.float32([0.125, 0, 0])
    x[:, S + 2] = x[:, 0] + np.float32([0.125 + 2 ** -20, 0, 0])
    return x


def _feat(seed, c=128):
    rng = np.random.RandomState(seed + 100)
    return np.concatenate([_grid_points(seed),
                           rng.randn(H, N, c).astype(np.float32)], -1)


def _assert_close_to_scale(got, want, tol=BWD_TOL):
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_matches_pallas_with_separate_centers(seed):
    """Centers are an operand of their own (``knn_pallas``'s contract):
    grid points that are not rows of the cloud, and S != N/2."""
    pts = _grid_points(seed)
    rng = np.random.RandomState(seed + 10)
    ctr = (rng.randint(-4, 5, (H, 2 * S, 3)) / 32.0).astype(np.float32)
    dist_j, idx_j = knn_pallas(jnp.asarray(ctr), jnp.asarray(pts), k=K,
                               interpret=True)
    dist_t, idx_t = sa.knn(torch.from_numpy(ctr), torch.from_numpy(pts), K)
    d = np.asarray(dist_j)
    assert (d[..., 1:] == d[..., :-1]).any(), "no ties planted"
    assert dist_t.dtype == torch.float32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(dist_t.numpy(), d)


def test_knn_wrapper_refuses_other_devices_and_launches_nothing_on_cpu():
    sa.reset_launches()
    pts = torch.from_numpy(_grid_points(0))
    sa.knn(pts[:, :S], pts, K)
    assert sa.launches["knn"] == 0
    with pytest.raises(ValueError):
        sa.knn(torch.zeros((H, S, 3), device="meta"),
               torch.zeros((H, N, 3), device="meta"), K)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("radius2", [R1, ON_RADIUS])
def test_knn_ball_query_matches_jax(method, radius2):
    """Selection plus the ball-query substitution, compared in float32: the
    planted row exactly on the radius stays, the one just outside becomes
    the center's own index."""
    pts = _grid_points(2)
    idx_j, valid_j = jax_grouping.knn_ball_query(
        jnp.asarray(pts[:, :S]), jnp.asarray(pts), K, radius2, "topk")
    idx_t, valid_t = grouping.knn_ball_query(
        torch.from_numpy(pts[:, :S]), torch.from_numpy(pts), K, radius2,
        method)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    if radius2 == ON_RADIUS:
        assert (idx_t[:, 0, 1] == S + 1).all() and valid_t[:, 0, 1].all()
        assert (idx_t[:, 0, 2] == 0).all() and not valid_t[:, 0, 2].any()


def test_knn_ball_query_approx_matches_jax():
    """``approx`` on the grid cloud (every distance a bf16 tie somewhere):
    validity equal to JAX's bit for bit (the same bf16 distances), and an
    index differs from JAX's only where both name points at the same bf16
    distance (``approx_max_k`` orders ties its own way;
    ``tests/test_torch_options.py`` holds the port to ``lax.top_k``)."""
    pts = _grid_points(0)
    idx_j, valid_j = jax_grouping.knn_ball_query(
        jnp.asarray(pts[:, :S]), jnp.asarray(pts), K, R1, "approx")
    idx_t, valid_t = grouping.knn_ball_query(
        torch.from_numpy(pts[:, :S]), torch.from_numpy(pts), K, R1,
        "approx")
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    d2 = grouping._pairwise_sqdist(torch.from_numpy(pts[:, :S]),
                                   torch.from_numpy(pts)).to(torch.bfloat16)
    at = lambda idx: d2.gather(-1, torch.as_tensor(np.asarray(idx)).long())
    assert torch.equal(at(idx_t), at(idx_j))


@pytest.mark.parametrize("method", METHODS)
def test_generic_group_points_match_jax_with_gradients(method):
    """Both levels of the generic branch, forward bit for bit and backward
    (autograd through the exact gather) against ``jax.vjp`` with seeded
    cotangents on both outputs."""
    for level, x, r2 in ((1, _grid_points(3), ON_RADIUS),
                         (2, _feat(4), R2)):
        if level == 1:
            fn_j = lambda p: jax_grouping.group_points(
                p, k=K, num_centers=S, radius2=r2, knn_method=method)
            fn_t = lambda p: grouping.group_points(p, K, S, r2, method)
        else:
            fn_j = lambda f: jax_grouping.group_points_level2(
                f, num_centers=S, k=K, radius2=r2, knn_method=method)
            fn_t = lambda f: grouping.group_points_level2(
                f, S, K, r2, torch.float32, method)
        (g_j, c_j), vjp = jax.vjp(fn_j, jnp.asarray(x))
        rng = np.random.RandomState(level)
        cots = [rng.randn(*a.shape).astype(np.float32) for a in (g_j, c_j)]
        (want,) = vjp(tuple(map(jnp.asarray, cots)))

        xt = torch.from_numpy(x).requires_grad_(True)
        g_t, c_t = fn_t(xt)
        np.testing.assert_array_equal(g_t.detach().numpy(), np.asarray(g_j))
        np.testing.assert_array_equal(c_t.detach().numpy(), np.asarray(c_j))
        (got,) = torch.autograd.grad((g_t, c_t), xt,
                                     tuple(map(torch.from_numpy, cots)))
        _assert_close_to_scale(got.numpy(), np.asarray(want))


def test_generic_grouping_takes_float32_xyz_only():
    """The selection runs on float32 xyz at both levels; a lower-precision
    cloud is refused rather than rounded into the distances."""
    feat = torch.from_numpy(_feat(5)).to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        grouping.group_points_level2(feat, S, K, R2, torch.bfloat16, "pallas")


@pytest.mark.parametrize("method", METHODS)
def test_pointnet_plus_generic_matches_jax(method):
    """The port's PointNetPlus on its generic branch (unfolded PointMLP and
    a max over k) against the JAX module's, eval mode, same weights; the
    neighbour sets of both levels must agree first."""
    rng = np.random.RandomState(0)
    B, res = 1, 64
    points = rng.uniform(-0.1, 0.1, (B, 2, N, 3)).astype(np.float32)
    choose = rng.randint(0, res * res, (B, 2, N)).astype(np.int32)
    emb = [rng.randn(B, res, res, 3).astype(np.float32),
           rng.randn(B, res // 2, res // 2, 64).astype(np.float32),
           rng.randn(B, res // 4, res // 4, 256).astype(np.float32)]
    kw = dict(knn_k=K, num_level1=S, num_level2=S, ball_radius=R1,
              ball_radius2=R2, input_feature_num=3, resolution=res)
    jmod = JaxPointNetPlus(knn_method=method, gather_method="take",
                           dtype=jnp.float32, **kw)
    variables = jmod.init({"params": jax.random.PRNGKey(0)}, points, emb,
                          choose, False)
    jax_sets, port_sets = [], []

    def recording(fn, log):
        def run(*a, **k):
            out = fn(*a, **k)
            log.append(np.sort(np.asarray(out[0]), -1))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_grouping, "knn_ball_query",
                   recording(jax_grouping.knn_ball_query, jax_sets))
        mp.setattr(grouping, "knn_ball_query",
                   recording(grouping.knn_ball_query, port_sets))
        ref = np.asarray(jmod.apply(variables, points, emb, choose, False))
        tmod = PointNetPlus(knn_method=method, **kw).eval()
        tmod.load_state_dict(convert.from_flax(variables, tmod))
        with torch.inference_mode():
            got = tmod(torch.from_numpy(points),
                       [torch.from_numpy(e).permute(0, 3, 1, 2) for e in emb],
                       torch.from_numpy(choose))
    assert len(jax_sets) == len(port_sets) == 2
    for a, b in zip(jax_sets, port_sets):
        np.testing.assert_array_equal(b, a, err_msg="neighbour sets differ")
    assert got.shape == (B, 2, 1024)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("kind", ["identical", "coarse", "n200"])
def test_knn_separate_centers_match_pallas_on_hard_clouds(kind):
    """``knn`` with its centers as an operand of their own (S = 128, the TPU
    kernel's tile) against ``knn_pallas`` in interpret mode on the cases a
    threshold selection stresses: every point and center the same (all
    distances 0), a 1/8 grid with more keys equal to the k-th than places
    left, and N = 200 points (not a multiple of 32)."""
    rng = np.random.RandomState(30)
    n = 200 if kind == "n200" else N
    if kind == "identical":
        pts = np.full((H, n, 3), 0.03, np.float32)
        ctr = np.full((H, S, 3), 0.03, np.float32)
    else:
        step, half = (1 / 8, 2) if kind == "coarse" else (1 / 32, 4)
        pts = (rng.randint(-half, half + 1, (H, n, 3)) * step).astype(
            np.float32)
        ctr = (rng.randint(-half, half + 1, (H, S, 3)) * step).astype(
            np.float32)
    for k in (1, K):
        dist_j, idx_j = knn_pallas(jnp.asarray(ctr), jnp.asarray(pts), k=k,
                                   interpret=True)
        dist_t, idx_t = sa.knn(torch.from_numpy(ctr), torch.from_numpy(pts),
                               k)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))
    if kind == "coarse":
        d = sa.knn(torch.from_numpy(ctr), torch.from_numpy(pts), K + 1)[0]
        assert (d[..., K - 1] == d[..., K]).any(), "no k-th-place ties"


def _six_channels(seed):
    """Grid xyz (``_grid_points``) with three more channels, the normals
    of a cloud at ``input_feature_num=6``."""
    rng = np.random.RandomState(seed + 200)
    return np.concatenate([_grid_points(seed),
                           rng.randn(H, N, 3).astype(np.float32)], -1)


@pytest.mark.parametrize("method", ["pallas_sa", "pallas_fused", "pallas"])
def test_six_channel_level1_takes_the_knn_route(method, monkeypatch):
    """Level 1 of an xyz + normals cloud under the fused methods takes the
    generic route with the ``knn`` selection (``grouping.py:139-153``: the
    fused kernel groups xyz only), never ``knn_group_xyz``: forward bit for
    bit against the JAX generic branch (on grid points the matmul
    expansion is exact, so its ``top_k`` is the exact selection, which
    ``knn_pallas`` makes on the TPU) and backward against ``jax.vjp``."""
    calls = []
    monkeypatch.setattr(grouping, "knn", lambda c, p, k: (
        calls.append((c.is_contiguous(), p.shape[-1])) or sa.knn(c, p, k)))
    monkeypatch.setattr(grouping, "knn_group_xyz", None)
    x = _six_channels(6)
    (g_j, c_j), vjp = jax.vjp(lambda p: jax_grouping.group_points(
        p, k=K, num_centers=S, radius2=ON_RADIUS, knn_method="topk"),
        jnp.asarray(x))
    rng = np.random.RandomState(7)
    cots = [rng.randn(*a.shape).astype(np.float32) for a in (g_j, c_j)]
    (want,) = vjp(tuple(map(jnp.asarray, cots)))
    xt = torch.from_numpy(x).requires_grad_(True)
    g_t, c_t = grouping.group_points(xt, K, S, ON_RADIUS, method)
    assert calls == [(True, 3)]
    assert g_t.shape == (H, S, K, 6)
    np.testing.assert_array_equal(g_t.detach().numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(c_t.detach().numpy(), np.asarray(c_j))
    (got,) = torch.autograd.grad((g_t, c_t), xt,
                                 tuple(map(torch.from_numpy, cots)))
    _assert_close_to_scale(got.numpy(), np.asarray(want))


def test_group_feat_route_under_inference_mode():
    """Level 2 of the six-channel eval and serving steps runs the fused
    feature grouping (the ``group_feat`` kernel on the card) under
    ``torch.inference_mode()``: the same rows as with autograd on, and as
    JAX's ``group_feat_pallas`` in interpret mode."""
    x = _feat(8)
    with torch.inference_mode():
        g_inf, c_inf = grouping.group_points_level2(
            torch.from_numpy(x), S, K, R2, torch.float32, "pallas_sa")
    assert g_inf.is_inference()
    g, c = grouping.group_points_level2(
        torch.from_numpy(x).requires_grad_(True), S, K, R2, torch.float32,
        "pallas_sa")
    torch.testing.assert_close(g_inf, g.detach(), rtol=0, atol=0)
    torch.testing.assert_close(c_inf, c.detach(), rtol=0, atol=0)
    old = jax_grouping._FUSED_INTERPRET
    jax_grouping._FUSED_INTERPRET = True
    try:
        g_j, _ = jax_grouping.group_points_level2(
            jnp.asarray(x), num_centers=S, k=K, radius2=R2,
            knn_method="pallas_sa")
    finally:
        jax_grouping._FUSED_INTERPRET = old
    np.testing.assert_array_equal(g_inf.numpy(), np.asarray(g_j))
