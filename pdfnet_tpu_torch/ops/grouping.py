"""Set-abstraction grouping with gradients (port of
``pdfnet_tpu/ops/grouping.py``).  ``knn_method`` picks the branch as there:

- ``"pallas_fused"`` / ``"pallas_sa"``: the fused branches, ``group_points``
  -> ``_fused_group_pallas`` and ``group_points_level2`` ->
  ``_fused_group_feat_pallas`` (the two kernels below);
- ``"topk"`` / ``"pallas"``, and level 1 of clouds wider than xyz under
  every method: the generic branch, ``knn_ball_query`` (the
  selection under ``no_grad``, as JAX's ``stop_gradient``), an exact row
  gather and xyz minus center, differentiated by autograd through the
  gather.  ``"pallas"`` selects with the ``ops.sa.knn`` kernel (K5),
  ``"topk"`` with a plain sort of the matmul-expanded distances;
- ``"approx"`` (``lax.approx_max_k``) has no counterpart and raises.

Two CUDA kernels replace the TPU kernels those branches call:

==============  ======================================================  ==================
wrapper         replaces (pdfnet_tpu/ops/pallas_knn.py)                  source
==============  ======================================================  ==================
knn_group_xyz   ``_knn_gather_kernel`` :82 via ``knn_gather_xyz_pallas``   csrc/sa_group.cu
                :434
group_feat      ``_knn_gather_feat_kernel`` :107 via ``group_feat_pallas``  csrc/sa_group.cu
                :331
==============  ======================================================  ==================

They make the selection of the eval kernels (``ops.sa``) and also write each
neighbour's index and squared distance, which the backward passes need.  As
there, each wrapper runs its plain version for a tensor on the CPU and
launches its kernel for a CUDA tensor, or raises; ``launches`` counts kernel
launches only.  Outputs are (H, S, k[, C]) directly: the (k, S) layout of the
TPU kernels is an artefact of Mosaic's lane-dense stores.

The backward passes are not kernels in the JAX package either (XLA one-hot
transpose matmuls, ``grouping.py:175-186`` and ``:210-225``); here they are
``scatter_add_`` inside one ``torch.autograd.Function`` per grouping op.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from pdfnet_tpu_torch.ops import cuda_build
from pdfnet_tpu_torch.ops.sa import (_GROUP_SIGS, _check, _check_cuda, _f32,
                                     _ptr, _stream, _workspace,
                                     check_selection_shape,
                                     group_select_plain, knn, knn_plain)

FUSED_METHODS = ("pallas_fused", "pallas_sa")
GENERIC_METHODS = ("topk", "pallas")

launches: Dict[str, int] = {"knn_group_xyz": 0, "group_feat": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---- plain versions --------------------------------------------------------

def knn_group_xyz_plain(points: torch.Tensor, num_centers: int, k: int):
    """Plain version of ``knn_group_xyz``: points (H, N, 3) float32 ->
    (dist (H, S, k), idx (H, S, k), neighbour xyz minus center (H, S, k, 3)),
    with no ball-query substitution."""
    dist, idx = knn_plain(points, num_centers, k)
    rows = points[torch.arange(points.shape[0], device=points.device)[:, None,
                                                                       None],
                  idx]
    return dist, idx, rows - points[:, :num_centers, None, :]


# ---- kernel wrappers -------------------------------------------------------

def knn_group_xyz(points: torch.Tensor, num_centers: int, k: int):
    """Level-1 selection and centered gather: points (H, N, 3) float32 ->
    (dist (H, S, k) float32 ascending, idx (H, S, k) int32 (int64 from the
    plain version), nbr (H, S, k, 3) float32, not ball-substituted)."""
    if points.device.type == "cpu":
        return knn_group_xyz_plain(points, num_centers, k)
    _check_cuda(points, "knn_group_xyz", (torch.float32,))
    H, N, C = points.shape
    if C != 3:
        raise ValueError(f"knn_group_xyz: points must be (H, N, 3), got {C}")
    check_selection_shape("knn_group_xyz", N, num_centers, k)
    dev = points.device
    dist = torch.empty((H, num_centers, k), dtype=torch.float32, device=dev)
    idx = torch.empty((H, num_centers, k), dtype=torch.int32, device=dev)
    nbr = torch.empty((H, num_centers, k, 3), dtype=torch.float32, device=dev)
    ws = _workspace(H, N, num_centers, k, dev)
    lib = cuda_build.library("sa_group.cu", _GROUP_SIGS)
    _check(lib.knn_group_xyz(points.data_ptr(), dist.data_ptr(),
                             idx.data_ptr(), nbr.data_ptr(), _ptr(ws), H, N,
                             num_centers, k, _stream()), "knn_group_xyz")
    launches["knn_group_xyz"] += 1
    return dist, idx, nbr


def group_feat(feat: torch.Tensor, num_centers: int, k: int, radius2: float):
    """Level-2 grouping with its selection: feat (H, N, C) float32 or
    bfloat16 -> (grouped (H, S, k, C) of feat's dtype, ball-substituted as
    ``ops.sa.sa_group_l2`` writes it, idx (H, S, k) int32 (int64 from the
    plain version), dist (H, S, k) float32)."""
    if feat.device.type == "cpu":
        grouped, dist, idx = group_select_plain(feat, num_centers, k, radius2)
        return grouped, idx, dist
    _check_cuda(feat, "group_feat", (torch.float32, torch.bfloat16))
    H, N, C = feat.shape
    if C < 3:
        raise ValueError(f"group_feat: needs xyz in the first 3 of C={C}")
    check_selection_shape("group_feat", N, num_centers, k)
    dev = feat.device
    out = torch.empty((H, num_centers, k, C), dtype=feat.dtype, device=dev)
    idx = torch.empty((H, num_centers, k), dtype=torch.int32, device=dev)
    dist = torch.empty((H, num_centers, k), dtype=torch.float32, device=dev)
    ws = _workspace(H, N, num_centers, k, dev)
    lib = cuda_build.library("sa_group.cu", _GROUP_SIGS)
    _check(lib.group_feat(feat.data_ptr(), out.data_ptr(), idx.data_ptr(),
                          dist.data_ptr(), _ptr(ws), H, N, C, num_centers, k,
                          _f32(radius2), int(feat.dtype == torch.bfloat16),
                          _stream()), "group_feat")
    launches["group_feat"] += 1
    return out, idx, dist


# ---- autograd functions ----------------------------------------------------

def _scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """d[h, n] = sum of g[h, s, j] over the (s, j) with idx[h, s, j] == n:
    (H, S, k, C), (H, S, k) -> (H, n, C), the transpose of the gather."""
    H, S, k, C = g.shape
    d = torch.zeros((H, n, C), dtype=g.dtype, device=g.device)
    return d.scatter_add_(1, idx.reshape(H, S * k, 1).long().expand(-1, -1, C),
                          g.reshape(H, S * k, C))


class _GroupPoints(torch.autograd.Function):
    """grouped[h, s, j] = points[h, idx] - points[h, s] where in the ball,
    else 0 (``_fused_group_pallas``)."""

    @staticmethod
    def forward(ctx, points, k, num_centers, radius2):
        dist, idx, nbr = knn_group_xyz(points.detach().float().contiguous(),
                                       num_centers, k)
        valid = dist <= _f32(radius2)
        ctx.save_for_backward(idx, valid)
        ctx.n, ctx.dtype = points.shape[1], points.dtype
        return torch.where(valid[..., None], nbr, 0.0)

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        gm = torch.where(valid[..., None], g, 0.0)
        d = _scatter_rows(gm, idx, ctx.n)
        d[:, :gm.shape[1]] -= gm.sum(dim=2)                 # the center term
        return d.to(ctx.dtype), None, None, None


class _GroupFeat(torch.autograd.Function):
    """Valid: grouped = feat[idx] - [center xyz, 0...]; out of the ball:
    [0, 0, 0, the center's other features] (``_fused_group_feat_pallas``)."""

    @staticmethod
    def forward(ctx, feat, k, num_centers, radius2, dtype):
        grouped, idx, dist = group_feat(feat.detach().to(dtype).contiguous(),
                                        num_centers, k, radius2)
        valid = dist <= _f32(radius2)
        ctx.save_for_backward(idx, valid)
        ctx.n = feat.shape[1]
        return grouped.to(feat.dtype)

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        g_valid = torch.where(valid[..., None], g, 0.0)
        g_inval = g - g_valid
        d = _scatter_rows(g_valid, idx, ctx.n)
        S = g.shape[1]
        d[:, :S, :3] -= g_valid[..., :3].sum(dim=2)
        d[:, :S, 3:] += g_inval[..., 3:].sum(dim=2)
        return d, None, None, None, None


# ---- the generic branch ----------------------------------------------------

def _pairwise_sqdist(centers: torch.Tensor, points: torch.Tensor
                     ) -> torch.Tensor:
    """(H, S, 3), (H, N, 3) -> (H, S, N) by the expansion |c|^2 + |p|^2 -
    2 c.p in float32, as ``grouping.py:34-46`` computes it."""
    cross = torch.einsum("bsc,bnc->bsn", centers, points)
    c2 = torch.sum(centers * centers, dim=-1)[:, :, None]
    p2 = torch.sum(points * points, dim=-1)[:, None, :]
    return c2 + p2 - 2.0 * cross


def knn_ball_query(centers: torch.Tensor, points: torch.Tensor, k: int,
                   radius2: float, method: str = "topk"):
    """Indices of the k nearest points per center, ball-query substituted
    (``grouping.py:49-99``): centers (H, S, 3), points (H, N, 3) -> (idx
    (H, S, k) int64, out-of-ball neighbours replaced by the center's own
    index; valid (H, S, k) bool, False where substituted).  The xyz must be
    float32, as they are at both levels of the model (a lower precision is
    refused, not rounded into the distances); ``radius2`` is compared in
    float32.  Not differentiable (integer output)."""
    if method in FUSED_METHODS:
        method = "pallas"            # the same selection; fusion is upstream
    if method not in GENERIC_METHODS:
        raise NotImplementedError(
            f"knn_method={method!r}: approx_max_k has no counterpart in the "
            f"port; use 'topk' or 'pallas'")
    if centers.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError(f"knn_ball_query: xyz must be float32, got "
                        f"{centers.dtype} centers, {points.dtype} points")
    with torch.no_grad(), torch.autocast(points.device.type, enabled=False):
        if method == "pallas":
            dist, idx = knn(centers.contiguous(), points.contiguous(), k)
        else:
            d2 = _pairwise_sqdist(centers, points)
            dist, idx = torch.sort(d2, dim=-1, stable=True)
            dist, idx = dist[..., :k], idx[..., :k]
        valid = dist <= _f32(radius2)
        center_idx = torch.arange(centers.shape[1], device=idx.device)
        idx = torch.where(valid, idx.long(), center_idx[None, :, None])
    return idx, valid


def gather_neighbors(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Exact row gather (H, N, C), (H, S, k) -> (H, S, k, C), differentiable
    in feat (``_gather_neighbors``: ``take`` and ``onehot`` are both exact)."""
    return feat[torch.arange(feat.shape[0], device=feat.device)[:, None, None],
                idx]


def _group_generic(feat: torch.Tensor, num_centers: int, k: int,
                   radius2: float, method: str) -> torch.Tensor:
    centers = feat[:, :num_centers, :3]
    idx, _ = knn_ball_query(centers, feat[..., :3], k, radius2, method)
    g = gather_neighbors(feat, idx)
    return torch.cat([g[..., :3] - centers[:, :, None, :], g[..., 3:]], dim=-1)


# ---- the two levels --------------------------------------------------------

def group_points(points: torch.Tensor, k: int, num_centers: int,
                 radius2: float, knn_method: str = "pallas_fused"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level-1 grouping: points (H, N, C), xyz leading -> (grouped
    (H, S, k, C), xyz center-relative; centers (H, S, 3)).  The fused
    branch takes xyz clouds (C = 3) and zeroes out-of-ball neighbours;
    wider clouds (xyz + normals) take the generic branch, whose
    out-of-ball neighbour is the center itself, as ``grouping.py:140-153``
    does (under the fused methods its selection is the ``knn`` kernel)."""
    if knn_method in FUSED_METHODS and points.shape[-1] == 3:
        grouped = _GroupPoints.apply(points, k, num_centers, radius2)
    else:
        grouped = _group_generic(points, num_centers, k, radius2, knn_method)
    return grouped, points[:, :num_centers, :3]


def group_points_level2(feat: torch.Tensor, num_centers: int, k: int,
                        radius2: float, dtype: torch.dtype,
                        knn_method: str = "pallas_fused"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level-2 grouping: feat (H, N, C), xyz leading -> (grouped (H, S, k, C)
    of feat's dtype, centers (H, S, 3)).  The fused branch groups its rows in
    ``dtype`` (the compute dtype: bf16 rows, and so bf16-rounded distances,
    as ``_fused_group_feat_fwd`` casts on the TPU); the generic one selects
    and gathers feat as it is."""
    if knn_method in FUSED_METHODS:
        grouped = _GroupFeat.apply(feat, k, num_centers, radius2, dtype)
    else:
        grouped = _group_generic(feat, num_centers, k, radius2, knn_method)
    return grouped, feat[:, :num_centers, :3]
