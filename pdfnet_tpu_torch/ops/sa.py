"""Set abstraction on the eval path: exact kNN grouping + BN-folded point MLP
+ max-pool, one call per PointNet++ level; and the exact kNN selection alone
(``knn``, the generic grouping's ``knn_method="pallas"``).

Port of ``sa_level1_pallas`` / ``sa_level2_pallas``
(``pdfnet_tpu/ops/pallas_knn.py:231`` and ``:290``), each of which chains a
grouping kernel and ``_mlpmax_feat_kernel``.  Three CUDA kernels replace the
three TPU kernel bodies:

================  ==============================================  =====================
wrapper           replaces (pdfnet_tpu/ops/pallas_knn.py)          source
================  ==============================================  =====================
sa_group_l1       ``_knn_gather_block_kernel`` :172                 csrc/sa_group.cu
sa_group_l2       ``_knn_gather_feat_kernel`` :107 (via :346)       csrc/sa_group.cu
sa_mlp_max        ``_mlpmax_feat_kernel`` :201 (``_mlp_folded``)    csrc/sa_mlp.cu
knn               ``_knn_kernel`` :70 (``knn_pallas`` :417)         csrc/sa_group.cu
================  ==============================================  =====================

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor, or raises: there is no fallback.
``launches`` counts kernel launches per wrapper; the plain versions never
touch it.  What bounds each kernel on the H100 is noted in its source.

Semantics (the TPU kernels', which the tests hold the plain versions to):

- selection: for each of the first S rows (the centers), the k rows with the
  smallest float32 d2 = (dx*dx + dy*dy) + dz*dz over the xyz channels,
  ascending, the lowest index winning ties;
- ball query: a neighbour with d2 > r2 (compared in float32) becomes the
  center's own row with zero xyz; in range, xyz becomes row - center;
- level 2 in bfloat16 groups bf16 rows, so its distances use the
  bf16-rounded xyz (as ``sa_level2_pallas`` casts before ``_group_feat_raw``);
- MLP: per layer, product in the compute dtype with a float32 accumulator,
  then bias + ReLU in float32; max over the k neighbours.

Limits: any k up to N, any N.  Clouds wider than ``WIDE_POINTS`` need a
global workspace, which the wrappers allocate; a selection whose lists and
staged cloud pass the block's shared memory (``MAX_SMEM``) keeps them in
that workspace and in device memory instead (``selection_spill``).

Compute dtype: the model's (``Config.compute_dtype``).  float32 reproduces
the TPU kernels' interpret mode, bfloat16 their on-chip mode.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pdfnet_tpu_torch.ops import cuda_build

launches: Dict[str, int] = {"sa_group_l1": 0, "sa_group_l2": 0,
                            "sa_mlp_max": 0, "knn": 0}

Folded = Sequence[Tuple[torch.Tensor, torch.Tensor]]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every entry point of csrc/sa_group.cu; ops.grouping binds the last two
_GROUP_SIGS = {"sa_group_l1": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
               "sa_group_l2": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
               "knn_group_xyz": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
               "group_feat": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                              _I, _P],
               "knn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}
_MLP_SIGS = {"sa_mlp_max": [_P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P, _P, _P]}
WIDE_POINTS = 1024       # csrc/sa_group.cu: wider clouds rank into a workspace
MLP_CHUNK = 64           # csrc/sa_mlp.cu: rows a block takes at a time
MLP_WIDTHS = ((64, 64, 128), (128, 128, 256))
# The shared memory a block may use on the H100 (227 KB): the selection
# spills past it, the MLP and trunk bodies name the shapes they refuse.
MAX_SMEM = 232448
_SEL_WARPS = 8           # csrc/sa_group.cu kWarps
_MLP_TC_CENTERS = 2      # csrc/sa_mlp.cu tc::kCenters
_MLP_F32_RING = 2 * 16 * 128   # csrc/sa_mlp.cu f32::kRing (floats)


def selection_smem_bytes(N: int, k: int) -> int:
    """Shared memory of the selection kernel (``csrc/sa_group.cu``
    ``smem_bytes``): per warp, k 8-byte composites, twice up to
    ``WIDE_POINTS`` points, once for wider clouds, whose ranked composites
    go to a global workspace; then the hand's xyz."""
    lists = 2 if N <= WIDE_POINTS else 1
    return lists * _SEL_WARPS * k * 8 + N * 3 * 4


def selection_spill(N: int, k: int) -> int:
    """Where the selection keeps what passes shared memory (``spill_of``,
    ``csrc/sa_group.cu``): 0 nothing spills; 1 the per-warp candidate
    lists go to a second half of the workspace (N = 4096 with k > 2864,
    k = N > 3058); 2 the cloud's xyz is read from device memory too (N >
    19370 at any k)."""
    if selection_smem_bytes(N, k) <= MAX_SMEM:
        return 0
    return 1 if N * 3 * 4 <= MAX_SMEM else 2


def check_selection_shape(name: str, N: int, S: int, k: int,
                          separate_centers: bool = False) -> None:
    """Raise ValueError for a selection that does not exist: S centers
    among N points (any S with separate centers) and 1 <= k <= N.  Every
    such shape runs; past shared memory it spills (``selection_spill``)."""
    if S < 1 or (not separate_centers and S > N) or not 1 <= k <= N:
        raise ValueError(f"{name}: needs 1 <= S <= N and 1 <= k <= N; got "
                         f"N={N}, S={S}, k={k}")


def mlp_tc_smem_bytes(C: int, widths: Sequence[int], k: int,
                      esize: int) -> int:
    """Shared memory of ``sa_mlp_max``'s bf16 (tensor-core) body
    (``tc::smem_bytes``): the three bf16 weight matrices, rows padded by 8
    and the first's depth C rounded up to 16; two buffers of the raw rows
    of a block's centers (k <= 64: k rows of C elements of ``esize`` bytes
    each, from the 16-byte boundary below; larger k: a slot of 64 rows a
    center, the chunk); float32 maxima of each 16-row warp."""
    F1, F2, F3 = widths
    c1p = -(-C // 16) * 16
    if k <= MLP_CHUNK:
        raw = -(-(_MLP_TC_CENTERS * k * C * esize + 16) // 16) * 16
    else:
        raw = _MLP_TC_CENTERS * (-(-(MLP_CHUNK * C * esize + 16) // 16) * 16)
    return (2 * (c1p * (F1 + 8) + F1 * (F2 + 8) + F2 * (F3 + 8)) + 2 * raw
            + 4 * _MLP_TC_CENTERS * (MLP_CHUNK // 16) * F3)


def check_mlp_tc_shape(C: int, widths: Sequence[int], k: int,
                       esize: int) -> None:
    """Raise ValueError, naming the limit, where ``sa_mlp_max``'s bf16 body
    cannot hold the weights and a chunk of rows in shared memory within
    ``MAX_SMEM`` (both eval levels fit at every k: float32 groups of C = 3
    and bf16 groups of C = 131)."""
    need = mlp_tc_smem_bytes(C, widths, k, esize)
    if need > MAX_SMEM:
        raise ValueError(f"sa_mlp_max: C={C}, k={k}, {esize}-byte groups, "
                         f"widths {tuple(widths)} need {need} bytes of "
                         f"shared memory, over the device's MAX_SMEM = "
                         f"{MAX_SMEM}")


def mlp_f32_smem_bytes(C: int, widths: Sequence[int]) -> int:
    """Shared memory of ``sa_mlp_max``'s float32 body (``f32::smem_floats``),
    for units of 128 rows: at level 1's widths the three float32 weights
    (w1's depth C rounded up to 4), the padded input rows, both hidden
    layers and the row groups' maxima; at level 2's, w2 and a ring of 2 x
    16 x 128 for the streamed w1 and w3, the input rows (C rounded up to 16,
    + 4) and one hidden layer at a time (the maxima over it)."""
    F1, F2, F3 = widths
    M = 128
    if F3 > 128:
        cp = -(-C // 16) * 16
        return 4 * (F1 * F2 + _MLP_F32_RING + M * (cp + 4)
                    + M * (max(F1, F2) + 4))
    cp = -(-C // 4) * 4
    return 4 * (cp * F1 + F1 * F2 + F2 * F3 + M * cp + M * (F1 + 4)
                + M * (F2 + 4) + 8 * 2 * F3)


def check_mlp_f32_shape(C: int, widths: Sequence[int]) -> None:
    """Raise ValueError, naming the limit, where ``sa_mlp_max``'s float32
    body cannot hold the weights and a unit's rows in shared memory within
    ``MAX_SMEM`` (both eval levels fit: C = 3 and C = 131; level 2's widths
    take C up to 144)."""
    need = mlp_f32_smem_bytes(C, widths)
    if need > MAX_SMEM:
        raise ValueError(f"sa_mlp_max: float32 C={C}, widths "
                         f"{tuple(widths)} need {need} bytes of shared "
                         f"memory, over the device's MAX_SMEM = {MAX_SMEM}")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _f32(radius2: float) -> float:
    """The float32 value of a radius, as a Python float: comparing a float32
    tensor against it gives the float32 comparison on any promotion path."""
    return float(np.float32(radius2))


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _check_cuda(t: torch.Tensor, name: str, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


# ---- plain versions --------------------------------------------------------

def knn_select_plain(centers: torch.Tensor, points: torch.Tensor, k: int):
    """Plain version of ``knn``: for each center (H, S, 3) the k nearest of
    points (H, N, 3), float32, by the exact d2 = (dx*dx + dy*dy) + dz*dz
    with d = p - c, ascending, the lowest index first among equal distances
    (NaN after +inf) -> (dist (H, S, k), idx (H, S, k) int64)."""
    diff = points[:, None, :, :] - centers[:, :, None, :]       # (H, S, N, 3)
    d2 = ((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
          + diff[..., 2] * diff[..., 2])
    # stable ascending sort: ties keep index order, the TPU kernels' rule
    dist, idx = torch.sort(d2, dim=-1, stable=True)
    return dist[..., :k], idx[..., :k]


def knn_plain(xyz: torch.Tensor, num_centers: int, k: int):
    """The selection every grouping kernel makes: ``knn_select_plain`` with
    the first S rows of xyz (H, N, 3) as the centers."""
    return knn_select_plain(xyz[:, :num_centers], xyz, k)


def group_select_plain(feat: torch.Tensor, num_centers: int, k: int,
                       radius2: float):
    """Plain version of the grouping kernels with the selection they make:
    feat (H, N, C), xyz in channels 0..2, float32 or bfloat16 ->
    (grouped (H, S, k, C) of feat's dtype, dist (H, S, k), idx (H, S, k))."""
    H, N, C = feat.shape
    S = num_centers
    xyz = feat[..., :3].float()
    ctr = xyz[:, :S]
    dist, idx = knn_plain(xyz, S, k)
    rows = feat[torch.arange(H, device=feat.device)[:, None, None], idx]
    rows = torch.cat([(rows[..., :3].float() - ctr[:, :, None, :]).to(feat.dtype),
                      rows[..., 3:]], dim=-1)
    own = feat[:, :S, None, :].clone()
    own[..., :3] = 0
    valid = (dist <= _f32(radius2))[..., None]
    return torch.where(valid, rows, own.expand_as(rows)), dist, idx


def group_plain(feat: torch.Tensor, num_centers: int, k: int,
                radius2: float) -> torch.Tensor:
    """Plain version of both eval grouping kernels.

    feat (H, N, C), xyz in channels 0..2, float32 or bfloat16 ->
    (H, S, k, C) of feat's dtype.
    """
    return group_select_plain(feat, num_centers, k, radius2)[0]


def mlp_max_plain(grouped: torch.Tensor, folded: Folded,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``sa_mlp_max``: (H, S, k, C) -> (H, S, F3) float32.

    Rounding the operands to the compute dtype and multiplying in float32
    is a product in that dtype with a float32 accumulator (a bf16 x bf16
    product is exact in float32).
    """
    with torch.autocast(grouped.device.type, enabled=False):
        h = grouped
        for w, b in folded:
            h = h.to(compute_dtype).float() @ w.to(compute_dtype).float()
            h = torch.relu(h + b.float())
        return h.amax(dim=2)


# ---- kernel wrappers -------------------------------------------------------

def _workspace(H: int, N: int, S: int, k: int,
               device) -> Optional[torch.Tensor]:
    """The selection's global workspace for wide clouds (N > WIDE_POINTS):
    (H, S, k) 8-byte entries, twice that where the selection spills its
    candidate lists (``selection_spill``); a null pointer otherwise.  Freed
    when the caller drops it, after the launch on the same stream."""
    if N <= WIDE_POINTS:
        return None
    halves = 2 if selection_spill(N, k) else 1
    return torch.empty((halves, H, S, k), dtype=torch.int64, device=device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def sa_group_l1(points: torch.Tensor, num_centers: int, k: int,
                radius2: float) -> torch.Tensor:
    """Level-1 grouping: points (H, N, 3) float32 -> (H, S, k, 3) float32,
    center-relative xyz, zero where out of the ball."""
    if points.device.type == "cpu":
        return group_plain(points, num_centers, k, radius2)
    _check_cuda(points, "sa_group_l1", (torch.float32,))
    H, N, C = points.shape
    if C != 3:
        raise ValueError(f"sa_group_l1: points must be (H, N, 3), got {C}")
    check_selection_shape("sa_group_l1", N, num_centers, k)
    out = torch.empty((H, num_centers, k, 3), dtype=points.dtype,
                      device=points.device)
    ws = _workspace(H, N, num_centers, k, points.device)
    lib = cuda_build.library("sa_group.cu", _GROUP_SIGS)
    _check(lib.sa_group_l1(points.data_ptr(), out.data_ptr(), _ptr(ws), H, N,
                           num_centers, k, _f32(radius2), _stream()),
           "sa_group_l1")
    launches["sa_group_l1"] += 1
    return out


def sa_group_l2(feat: torch.Tensor, num_centers: int, k: int,
                radius2: float) -> torch.Tensor:
    """Level-2 grouping: feat (H, N, C) float32 or bfloat16 -> (H, S, k, C)
    of the same dtype; out-of-ball neighbours become the center's own row
    with zero xyz."""
    if feat.device.type == "cpu":
        return group_plain(feat, num_centers, k, radius2)
    _check_cuda(feat, "sa_group_l2", (torch.float32, torch.bfloat16))
    H, N, C = feat.shape
    if C < 3:
        raise ValueError(f"sa_group_l2: needs xyz in the first 3 of C={C}")
    check_selection_shape("sa_group_l2", N, num_centers, k)
    out = torch.empty((H, num_centers, k, C), dtype=feat.dtype,
                      device=feat.device)
    ws = _workspace(H, N, num_centers, k, feat.device)
    lib = cuda_build.library("sa_group.cu", _GROUP_SIGS)
    _check(lib.sa_group_l2(feat.data_ptr(), out.data_ptr(), _ptr(ws), H, N, C,
                           num_centers, k, _f32(radius2),
                           int(feat.dtype == torch.bfloat16), _stream()),
           "sa_group_l2")
    launches["sa_group_l2"] += 1
    return out


def sa_mlp_max(grouped: torch.Tensor, folded: Folded,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """BN-folded 3-layer MLP + max over k: (H, S, k, C) -> (H, S, F3) f32."""
    if grouped.device.type == "cpu":
        return mlp_max_plain(grouped, folded, compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sa_mlp_max: compute dtype {compute_dtype}")
    _check_cuda(grouped, "sa_mlp_max",
                (torch.float32, torch.bfloat16) if bf16 else (torch.float32,))
    H, S, k, C = grouped.shape
    widths = tuple(w.shape[1] for w, _ in folded)
    if widths not in MLP_WIDTHS or folded[0][0].shape[0] != C or k < 1:
        raise ValueError(f"sa_mlp_max: unsupported C={C}, widths={widths}, "
                         f"k={k} (widths {MLP_WIDTHS}, k >= 1)")
    if bf16:
        check_mlp_tc_shape(C, widths, k, grouped.element_size())
    else:
        check_mlp_f32_shape(C, widths)
    # weights in the compute dtype, biases float32
    params = []
    for w, b in folded:
        params += [w.to(compute_dtype).contiguous(), b.float().contiguous()]
    for i, p in enumerate(params):
        _check_cuda(p, "sa_mlp_max",
                    (compute_dtype if i % 2 == 0 else torch.float32,))
        if p.device != grouped.device:
            raise ValueError("sa_mlp_max: weights on another device")
    out = torch.empty((H, S, widths[-1]), dtype=torch.float32,
                      device=grouped.device)
    lib = cuda_build.library("sa_mlp.cu", _MLP_SIGS)
    _check(lib.sa_mlp_max(grouped.data_ptr(),
                          int(grouped.dtype == torch.bfloat16), int(bf16),
                          H * S, k, C, *widths,
                          *(p.data_ptr() for p in params), out.data_ptr(),
                          _stream()),
           "sa_mlp_max")
    launches["sa_mlp_max"] += 1
    return out


def knn(centers: torch.Tensor, points: torch.Tensor, k: int):
    """Exact k nearest points per center (``knn_pallas``): centers (H, S, 3)
    and points (H, N, 3) float32 -> (dist (H, S, k) float32 ascending, idx
    (H, S, k) int32 (int64 from the plain version)).  Any S on the card,
    any N and 1 <= k <= N."""
    if centers.device.type == "cpu" and points.device.type == "cpu":
        return knn_select_plain(centers, points, k)
    for t in (centers, points):
        _check_cuda(t, "knn", (torch.float32,))
    H, S, C = centers.shape
    N = points.shape[1]
    if (C != 3 or points.shape != (H, N, 3)
            or points.device != centers.device):
        raise ValueError(f"knn: needs centers (H, S, 3) and points (H, N, 3) "
                         f"on one device; got {tuple(centers.shape)}, "
                         f"{tuple(points.shape)}")
    check_selection_shape("knn", N, S, k, separate_centers=True)
    dist = torch.empty((H, S, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((H, S, k), dtype=torch.int32, device=points.device)
    ws = _workspace(H, N, S, k, points.device)
    lib = cuda_build.library("sa_group.cu", _GROUP_SIGS)
    _check(lib.knn(centers.data_ptr(), points.data_ptr(), dist.data_ptr(),
                   idx.data_ptr(), _ptr(ws), H, N, S, k, _stream()), "knn")
    launches["knn"] += 1
    return dist, idx


# ---- one set-abstraction level ---------------------------------------------

def sa_level1(points: torch.Tensor, folded: Folded, k: int, num_centers: int,
              radius2: float, compute_dtype: torch.dtype) -> torch.Tensor:
    """Level-1 set abstraction (``sa_level1_pallas``): points (H, N, 3),
    the first ``num_centers`` rows the centers -> (H, S, F3) float32."""
    grouped = sa_group_l1(points.float().contiguous(), num_centers, k, radius2)
    return sa_mlp_max(grouped, folded, compute_dtype)


def sa_level2(feat: torch.Tensor, folded: Folded, k: int, num_centers: int,
              radius2: float, compute_dtype: torch.dtype) -> torch.Tensor:
    """Level-2 set abstraction (``sa_level2_pallas``): feat (H, N, C) with
    xyz leading, grouped in the compute dtype -> (H, S, F3) float32."""
    grouped = sa_group_l2(feat.to(compute_dtype).contiguous(), num_centers,
                          k, radius2)
    return sa_mlp_max(grouped, folded, compute_dtype)
