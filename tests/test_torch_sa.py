"""The port's set abstraction (``pdfnet_tpu_torch.ops.sa``) against the JAX
Pallas kernels in interpret mode.

On CPU tensors the port's wrappers run their plain PyTorch versions, so these
tests hold the plain versions (which ``chip_smoke.py`` in turn holds the CUDA
kernels to, on the card) to the TPU kernels' semantics:

- selection: identical neighbour indices, ties included (planted by a dyadic
  grid on which every distance is exact), against ``knn_pallas`` and
  ``group_feat_pallas``, which run the same ``_select_loop`` as
  ``sa_level{1,2}_pallas``;
- grouping: bit-identical grouped rows, with points exactly on the radius;
- pooled features: ``atol=rtol=1e-5`` (float32 sums in another order).

Do not compare with the JAX ``topk`` path: it ranks by the matmul expansion
of the distance (``grouping.py:34-46``), whose rounding reorders near ties.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.models.pointnet import PointNetPlus as JaxPointNetPlus
from pdfnet_tpu.ops import grouping
from pdfnet_tpu.ops.pallas_knn import (_mlp_folded, group_feat_pallas,
                                       knn_pallas, sa_level1_pallas,
                                       sa_level2_pallas)

from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.models.pointnet import PointMLP, PointNetPlus, _fold_point_mlp
from pdfnet_tpu_torch.ops import sa
from test_torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
H, N, S, K = 2, 256, 128, 8
R1, R2 = 0.015, 0.04
TOL = dict(atol=1e-5, rtol=1e-5)


def _grid_points(seed, n=N, c=3):
    """Points on a 1/32 grid in [-1/8, 1/8]^3: every difference and squared
    distance is exact in float32, so equal distances are exact ties.  Row
    S+1 of each hand sits at distance exactly 1/8 from center 0 (d2 = 1/64,
    on the test radius below); row S+2 just outside it."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-4, 5, (H, n, c)).astype(np.float32) / 32.0
    x[:, S + 1, :3] = x[:, 0, :3] + np.float32([0.125, 0, 0])
    x[:, S + 2, :3] = x[:, 0, :3] + np.float32([0.125 + 2 ** -20, 0, 0])
    return x


def _folded(widths, cin, seed):
    rng = np.random.RandomState(seed)
    out = []
    for f in widths:
        out.append((rng.randn(cin, f).astype(np.float32) / np.sqrt(cin),
                    rng.uniform(-0.3, 0.3, f).astype(np.float32)))
        cin = f
    return out


def _torch_folded(folded):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in folded]


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_selection_matches_pallas_with_ties(seed):
    pts = _grid_points(seed)
    dist_j, idx_j = knn_pallas(jnp.asarray(pts[:, :S]), jnp.asarray(pts),
                               k=K, interpret=True)
    dist_t, idx_t = sa.knn_plain(torch.from_numpy(pts), S, K)
    d = np.asarray(dist_j)
    assert (d[..., 1:] == d[..., :-1]).any(), "no ties planted"
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(dist_t.numpy(), d)


@pytest.mark.parametrize("radius2", [R1, 1.0 / 64])
def test_group_l1_matches_pallas_bitwise(radius2):
    """Level-1 grouping (C = 3: out-of-ball neighbours become zeros)."""
    pts = _grid_points(2)
    g_j, idx_j, valid_j = group_feat_pallas(jnp.asarray(pts), k=K,
                                            num_centers=S, radius2=radius2,
                                            interpret=True)
    g_t = sa.sa_group_l1(torch.from_numpy(pts), S, K, radius2)
    if radius2 == 1.0 / 64:      # the planted rows straddle the radius
        v = np.asarray(valid_j)[:, 0][np.asarray(idx_j)[:, 0] == S + 1]
        assert v.all()
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_l2_matches_pallas_bitwise(dtype):
    """Level-2 grouping of 131-wide rows; in bf16 the rows, and so the xyz
    the distances use, are bf16 (``sa_level2_pallas`` casts first)."""
    rng = np.random.RandomState(3)
    feat = np.concatenate([_grid_points(3)[..., :3],
                           rng.randn(H, N, 128).astype(np.float32)], -1)
    fj = jnp.asarray(feat).astype(dtype)
    g_j, _, _ = group_feat_pallas(fj, k=K, num_centers=S, radius2=1.0 / 64,
                                  interpret=True)
    ft = torch.from_numpy(feat).to(getattr(torch, dtype))
    g_t = sa.sa_group_l2(ft, S, K, 1.0 / 64)
    assert g_t.dtype == ft.dtype
    np.testing.assert_array_equal(g_t.float().numpy(),
                                  np.asarray(g_j.astype(jnp.float32)))


def test_sa_level1_matches_pallas():
    pts = np.random.RandomState(4).uniform(-0.1, 0.1, (H, N, 3)).astype(np.float32)
    folded = _folded(sa.MLP_WIDTHS[0], 3, 5)
    ref = sa_level1_pallas(jnp.asarray(pts), folded, k=K, num_centers=S,
                           radius2=R1, interpret=True)
    got = sa.sa_level1(torch.from_numpy(pts), _torch_folded(folded), K, S,
                       R1, torch.float32)
    assert got.shape == (H, S, sa.MLP_WIDTHS[0][-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_sa_level2_matches_pallas():
    rng = np.random.RandomState(6)
    feat = np.concatenate([rng.uniform(-0.1, 0.1, (H, N, 3)),
                           rng.randn(H, N, 128)], -1).astype(np.float32)
    folded = _folded(sa.MLP_WIDTHS[1], 131, 7)
    ref = sa_level2_pallas(jnp.asarray(feat), folded, k=K, num_centers=S,
                           radius2=R2, interpret=True)
    got = sa.sa_level2(torch.from_numpy(feat), _torch_folded(folded), K, S,
                       R2, torch.float32)
    assert got.shape == (H, S, sa.MLP_WIDTHS[1][-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_mlp_max_bf16_matches_pallas_mlp():
    """bf16 compute: operands rounded to bf16, float32 accumulate, as the
    TPU kernel's ``_mlp_folded`` with compute dtype bf16.

    The hidden activations are rounded to bf16 (eps 2**-8 = 3.9e-3) after
    float32 sums taken in another order on each side, so an activation near
    a rounding boundary can land one bf16 step apart and carry that through
    the next layer: seen up to 2e-3 absolute on outputs of ~1.  Held to
    ``atol=rtol=1e-2``, about two bf16 steps."""
    rng = np.random.RandomState(8)
    g = rng.randn(H, S, K, 131).astype(np.float32)
    folded = _folded(sa.MLP_WIDTHS[1], 131, 9)
    h = _mlp_folded(jnp.asarray(g.reshape(-1, 131)),
                    [jnp.asarray(w) for w, _ in folded],
                    [jnp.asarray(b)[None] for _, b in folded], jnp.bfloat16)
    ref = np.asarray(h).reshape(H, S, K, -1).max(axis=2)
    got = sa.sa_mlp_max(torch.from_numpy(g), _torch_folded(folded),
                        torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=1e-2)


def _sort_neighbors(g):
    """Neighbour rows of (B, S, K, C) in lexicographic order."""
    out = np.empty_like(g)
    for b in range(g.shape[0]):
        for s in range(g.shape[1]):
            rows = g[b, s]
            out[b, s] = rows[np.lexsort(rows.T[::-1])]
    return out


@pytest.mark.parametrize("level", [1, 2])
def test_group_plain_matches_reference_goldens(level):
    """Full-size grouping (1024 -> 512 -> 128 points, k=64) against the
    torch reference's recorded output, compared as neighbour sets (the
    reference's topk order is arbitrary)."""
    g = np.load(os.path.join(GOLDENS, "grouping.npz"))
    if level == 1:
        got = sa.group_plain(torch.from_numpy(g["points"]), 512, 64, R1)
        ref = np.transpose(g["level1"], (0, 2, 3, 1))
    else:
        feat = np.ascontiguousarray(np.transpose(g["feat2"], (0, 2, 1)))
        got = sa.group_plain(torch.from_numpy(feat), 128, 64, R2)
        ref = np.transpose(g["level2"], (0, 2, 3, 1))
    np.testing.assert_allclose(_sort_neighbors(got.numpy()),
                               _sort_neighbors(ref), atol=1e-6)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused rather than run through the plain version."""
    pts = torch.zeros((H, N, 3), device="meta")
    with pytest.raises(ValueError):
        sa.sa_group_l1(pts, S, K, R1)
    with pytest.raises(ValueError):
        sa.sa_group_l2(torch.zeros((H, N, 131), device="meta"), S, K, R2)
    with pytest.raises(ValueError):
        sa.sa_mlp_max(torch.zeros((H, S, K, 3), device="meta"),
                      [(torch.zeros(3, 64), torch.zeros(64))], torch.float32)


def _jitter(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _jitter(v, rng)
        elif k == "var":
            out[k] = np.asarray(v) + rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "mean":
            out[k] = np.asarray(v) + rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def test_fold_point_mlp_matches_bn_eval():
    """The fold reproduces Linear + BatchNorm(eval) + ReLU."""
    torch.manual_seed(0)
    mlp = PointMLP(16, (8, 12, 8)).eval()
    with torch.no_grad():
        for i in range(3):
            bn = getattr(mlp, f"bn{i}")
            bn.running_mean.uniform_(-0.3, 0.3)
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.3, 0.3)
    x = torch.randn(4, 7, 16)
    h = x
    for w, b in _fold_point_mlp(mlp):
        h = torch.relu(h @ w + b)
    np.testing.assert_allclose(h.detach().numpy(), mlp(x).detach().numpy(),
                               **TOL)


def test_pointnet_plus_matches_jax(monkeypatch):
    """The port's PointNetPlus (plain set abstraction) against the JAX one
    on its pallas_sa path in interpret mode, same weights, jittered BN."""
    monkeypatch.setattr(grouping, "_FUSED_INTERPRET", True)
    rng = np.random.RandomState(0)
    B, res = 1, 64
    points = rng.uniform(-0.1, 0.1, (B, 2, N, 3)).astype(np.float32)
    choose = rng.randint(0, res * res, (B, 2, N)).astype(np.int32)
    emb = [rng.randn(B, res, res, 3).astype(np.float32),
           rng.randn(B, res // 2, res // 2, 64).astype(np.float32),
           rng.randn(B, res // 4, res // 4, 256).astype(np.float32)]
    kw = dict(knn_k=K, num_level1=S, num_level2=S, ball_radius=R1,
              ball_radius2=R2, input_feature_num=3, resolution=res)
    jmod = JaxPointNetPlus(knn_method="pallas_sa", gather_method="take",
                           dtype=jnp.float32, **kw)
    variables = jmod.init({"params": jax.random.PRNGKey(0)}, points, emb,
                          choose, False)
    variables = _jitter(variables, rng)
    ref = np.asarray(jmod.apply(variables, points, emb, choose, False))

    tmod = PointNetPlus(**kw).eval()
    tmod.load_state_dict(convert.from_flax(variables, tmod))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(points),
                   [torch.from_numpy(e).permute(0, 3, 1, 2) for e in emb],
                   torch.from_numpy(choose))
    assert got.shape == (B, 2, 1024)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("level", [1, 2])
def test_mlp_tc_shape_guard(level):
    """Both eval levels' groups (float32 at level 1, bf16 at level 2) fit
    the bf16 body's shared memory at k = 64 and at any larger k, whose rows
    the body takes in chunks of 64; a first layer far wider than the eval
    path's is refused by name."""
    C, esize = ((3, 4), (131, 2))[level - 1]
    widths = sa.MLP_WIDTHS[level - 1]
    for k in (sa.MLP_CHUNK, 128, 1024, 4096):
        sa.check_mlp_tc_shape(C, widths, k, esize)
        assert sa.mlp_tc_smem_bytes(C, widths, k, esize) <= sa.MAX_SMEM
    assert (sa.mlp_tc_smem_bytes(C, widths, 4096, esize)
            == sa.mlp_tc_smem_bytes(C, widths, 128, esize))
    with pytest.raises(ValueError, match="MAX_SMEM"):
        sa.check_mlp_tc_shape(600, widths, sa.MLP_CHUNK, esize)


@pytest.mark.parametrize("level", [1, 2])
def test_mlp_f32_shape_guard(level):
    """Both eval levels' float32 groups (C = 3 and 131, and six-channel
    clouds' C = 6 and 134) fit the float32 body's shared memory, whatever
    k (its units are 128 rows): level 1 holds all three weights (50 KB),
    level 2 w2 (64 KB) beside a ring for the streamed w1 and w3; a first
    layer far wider than the eval path's is refused by name."""
    widths = sa.MLP_WIDTHS[level - 1]
    for C in ((3, 6), (131, 134))[level - 1]:
        sa.check_mlp_f32_shape(C, widths)
        assert sa.mlp_f32_smem_bytes(C, widths) <= sa.MAX_SMEM
    C = (3, 131)[level - 1]
    assert sa.mlp_f32_smem_bytes(C, widths) == (130048, 225280)[level - 1]
    with pytest.raises(ValueError, match="MAX_SMEM"):
        sa.check_mlp_f32_shape(600, widths)


# ---- the cases a threshold selection stresses ------------------------------

def _cloud(kind):
    """(H, N, 3) float32 clouds for the selection's hard cases, S = 128
    centers (the TPU kernel's tile) being the first rows:

    - ``identical``: every point the same, so every distance is 0 and the
      k nearest are the first k rows;
    - ``coarse``: a 1/8 grid of 125 cells under 256 points, so many keys
      equal the k-th and more of them than places left (k-th-place ties);
    - ``n200``: N = 200 points on the 1/32 grid, not a multiple of 32;
    - ``inf_cluster``: 100 rows (more than k) at x = 1e30, so a finite
      center sees them at d2 = +inf and the centers among them (rows
      100..127) see each other at finite d2 and the rest at +inf."""
    rng = np.random.RandomState({"identical": 20, "coarse": 21, "n200": 22,
                                 "inf_cluster": 23}[kind])
    if kind == "identical":
        return np.tile(np.float32([[[0.05, -0.02, 0.03]]]), (H, N, 1))
    if kind == "coarse":
        return (rng.randint(-2, 3, (H, N, 3)) / 8.0).astype(np.float32)
    x = (rng.randint(-4, 5, (H, 200 if kind == "n200" else N, 3))
         / 32.0).astype(np.float32)
    if kind == "inf_cluster":
        x[:, 100:200, 0] = 1e30
    return x


CLOUDS = ("identical", "coarse", "n200", "inf_cluster")


@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("kind", CLOUDS)
def test_knn_selection_matches_pallas_on_hard_clouds(kind, k):
    """The plain selection against ``knn_pallas`` in interpret mode, index
    and distance bit for bit; the coarse grid has rows whose k-th distance
    recurs beyond the k-th place."""
    pts = _cloud(kind)
    dist_j, idx_j = knn_pallas(jnp.asarray(pts[:, :S]), jnp.asarray(pts),
                               k=k, interpret=True)
    dist_t, idx_t = sa.knn_plain(torch.from_numpy(pts), S, k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))
    if kind == "coarse":
        d = sa.knn_plain(torch.from_numpy(pts), S, k + 1)[0].numpy()
        assert (d[..., k - 1] == d[..., k]).any(), "no k-th-place ties"


@pytest.mark.parametrize("kind", CLOUDS)
def test_grouping_matches_pallas_on_hard_clouds(kind):
    """Level-1 grouping (zeros out of the ball) and level-2 rows of 131
    float32 and bf16 channels against ``group_feat_pallas`` bit for bit at
    the radius 1/64, on which the grid clouds put many points; level-1 set
    abstraction against ``sa_level1_pallas`` within ``TOL``."""
    pts = _cloud(kind)
    r2 = 1.0 / 64
    g_j, _, _ = group_feat_pallas(jnp.asarray(pts), k=K, num_centers=S,
                                  radius2=r2, interpret=True)
    np.testing.assert_array_equal(
        sa.sa_group_l1(torch.from_numpy(pts), S, K, r2).numpy(),
        np.asarray(g_j))
    rng = np.random.RandomState(24)
    feat = np.concatenate([pts, rng.randn(*pts.shape[:2], 128)], -1)
    for dtype in ("float32", "bfloat16"):
        fj = jnp.asarray(feat).astype(dtype)
        g_j, _, _ = group_feat_pallas(fj, k=K, num_centers=S, radius2=r2,
                                      interpret=True)
        g_t = sa.sa_group_l2(torch.from_numpy(feat).to(getattr(torch, dtype)),
                             S, K, r2)
        np.testing.assert_array_equal(g_t.float().numpy(),
                                      np.asarray(g_j.astype(jnp.float32)))
    folded = _folded(sa.MLP_WIDTHS[0], 3, 25)
    ref = sa_level1_pallas(jnp.asarray(pts), folded, k=K, num_centers=S,
                           radius2=r2, interpret=True)
    got = sa.sa_level1(torch.from_numpy(pts), _torch_folded(folded), K, S,
                       r2, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _stable_sort_select(pts, k, s=S):
    """numpy reference of the port's selection contract, the first s rows
    the centers: float32 d2 in the direct form, a stable ascending sort (NaN
    after +inf, equal keys in index order) -> (dist, idx) of the first k."""
    with np.errstate(invalid="ignore"):
        diff = pts[:, None, :, :] - pts[:, :s, None, :]
        d2 = ((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
              + diff[..., 2] * diff[..., 2])
    idx = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(d2, idx, -1), idx


@pytest.mark.parametrize("n_finite", [N - 200, 16])
def test_knn_selection_on_non_finite_clouds(n_finite):
    """NaN and inf clusters larger than k, centers inside them; with 16
    finite rows the selection of a finite center reaches into the +inf and
    NaN keys.  The TPU kernel defines no order there (one NaN distance in a
    row makes its min NaN, and it emits index N for every place; past the
    finite keys it repeats indices), so the port's contract, NaN after
    +inf and no index twice, is held to numpy's stable argsort."""
    rng = np.random.RandomState(26)
    pts = (rng.randint(-4, 5, (H, N, 3)) / 32.0).astype(np.float32)
    n_bad = N - n_finite
    pts[:, 10:10 + n_bad // 2] = np.nan
    pts[:, 10 + n_bad // 2:10 + n_bad, 1] = np.inf
    for k in (K, 64):
        want_d, want_i = _stable_sort_select(pts, k)
        dist, idx = sa.knn_plain(torch.from_numpy(pts), S, k)
        np.testing.assert_array_equal(idx.numpy(), want_i)
        np.testing.assert_array_equal(dist.numpy(), want_d)
        assert (np.sort(idx.numpy(), -1)[..., 1:]
                != np.sort(idx.numpy(), -1)[..., :-1]).all()


@pytest.mark.parametrize("non_finite", [False, True])
def test_knn_selection_of_the_whole_cloud(non_finite):
    """k = N = 1024, the widest selection the kernel takes (its shared
    memory opts in above 48 KB there), 64 centers on the 1/32 grid, with
    and without NaN and inf clusters of 100 rows: every point once, in the
    stable order of numpy's argsort, held to it bit for bit."""
    rng = np.random.RandomState(27)
    pts = (rng.randint(-4, 5, (H, 1024, 3)) / 32.0).astype(np.float32)
    if non_finite:
        pts[:, 40:140] = np.nan
        pts[:, 300:400, 0] = np.inf
    want_d, want_i = _stable_sort_select(pts, 1024, 64)
    dist, idx = sa.knn_plain(torch.from_numpy(pts), 64, 1024)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(dist.numpy(), want_d)
    assert (np.sort(idx.numpy(), -1) == np.arange(1024)).all()
