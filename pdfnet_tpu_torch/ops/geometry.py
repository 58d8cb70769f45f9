"""Camera geometry: depth lifting, surface normals, projections and root
lifting (port of ``pdfnet_tpu/ops/geometry.py``).

The JAX versions run their products at ``Precision.HIGHEST``; here they are
float32 products, which stay float32 on the card because
``torch.backends.cuda.matmul.allow_tf32`` is off by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the 5x5 dilation-2 neighbourhood of get_normal (reference
# lib/utils/utils.py:264-310), row offset outer, column offset inner
NORMAL_OFFSETS = (-4, -2, 0, 2, 4)
# below this det(A^T A) the plane fit solves against the identity instead,
# and the "normal" is the normalized sum of the neighbours (the viewing ray)
NORMAL_DET_MIN = 1e-5


def backproject_depth(depth: torch.Tensor,
                      K_inv: torch.Tensor) -> torch.Tensor:
    """Lift depth (..., H, W), metric, zero where invalid, with inverse
    intrinsics K_inv (..., 3, 3) to camera-space xyz (..., H, W, 3); pixel
    (row y, column x) takes the ray K_inv [x, y, 1] (no half-pixel offset,
    as the reference)."""
    H, W = depth.shape[-2:]
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device),
        indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    rays = torch.einsum("...ij,hwj->...hwi", K_inv.float(), pix)
    return rays * depth[..., None]


def _shifted(points: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-padded spatial shift of (..., H, W, C): out[y, x] = points[y +
    dy, x + dx], 0 outside (|dy|, |dx| <= 4)."""
    H, W = points.shape[-3], points.shape[-2]
    p = F.pad(points, (0, 0, 4, 4, 4, 4))
    return p[..., 4 + dy:4 + dy + H, 4 + dx:4 + dx + W, :]


def plane_normals(nbrs: torch.Tensor) -> torch.Tensor:
    """Least-squares plane fit through neighbourhoods (..., 25, 3): solve
    (A^T A) n = A^T 1, with the identity for A^T A when its determinant is
    below NORMAL_DET_MIN, then L2-normalize -> (..., 3), in float32 also
    under autocast (the model's bf16 forward builds its clouds inside it).
    No host synchronisation (``solve_ex`` does not check for
    singularity)."""
    with torch.autocast(nbrs.device.type, enabled=False):
        ata = torch.einsum("...ki,...kj->...ij", nbrs, nbrs)
    atb = nbrs.sum(dim=-2)
    det = torch.linalg.det(ata)
    eye = torch.eye(3, dtype=nbrs.dtype, device=nbrs.device)
    safe = torch.where((det >= NORMAL_DET_MIN)[..., None, None], ata, eye)
    n = torch.linalg.solve_ex(safe, atb[..., None])[0][..., 0]
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)


def depth_normals(points: torch.Tensor) -> torch.Tensor:
    """Per-pixel unit normals (..., H, W, 3) of backprojected points
    (..., H, W, 3): ``plane_normals`` over each pixel's zero-padded 5x5
    dilation-2 neighbourhood.  The cloud builder computes the same at the
    sampled pixels only (``ops.pointcloud.normals_at``)."""
    nbrs = torch.stack([_shifted(points, dy, dx) for dy in NORMAL_OFFSETS
                        for dx in NORMAL_OFFSETS], dim=-2)
    return plane_normals(nbrs)


def orthographic_project(scale: torch.Tensor, trans2d: torch.Tensor,
                         points3d: torch.Tensor,
                         img_size: int = 384) -> torch.Tensor:
    """Weak-perspective projection used by the GCN decoder.

    scale: (B,), trans2d: (B, 2), points3d: (B, N, 3) -> (B, N, 2).
    """
    s = (scale * img_size)[:, None, None]
    t = (trans2d * img_size / 2 + img_size / 2)[:, None, :]
    return s * points3d[..., :2] + t


def perspective_project(points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x (B, 3, 3) -> (B, N, 2) pinhole projection."""
    proj = torch.einsum("bnj,bij->bni", points, K)
    return proj[..., :2] / (proj[..., 2:] + 1e-7)


def uv_root_to_3d(index: torch.Tensor, offset_xy: torch.Tensor,
                  depth: torch.Tensor, K: torch.Tensor, input_res: int = 384,
                  down_ratio: int = 4) -> torch.Tensor:
    """Lift (center cell index, predicted sub-cell offset, predicted z) to an
    absolute 3D root position via the intrinsics.

    index: (B,) or (B, 1) flat index into the down-sampled center grid;
    offset_xy: (B, 2) pixels; depth: (B,) metric z; K: (B, 3, 3).
    Returns (B, 1, 3).
    """
    idx = index.reshape(index.shape[0]).long()
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cw, ch = K[:, 0, 2], K[:, 1, 2]
    grid = input_res // down_ratio
    cx = ((idx % grid) * down_ratio).to(torch.float32)
    cy = ((idx // grid) * down_ratio).to(torch.float32)
    root_x = depth * (offset_xy[:, 0] + cx - cw) / (fx + 1e-7)
    root_y = depth * (offset_xy[:, 1] + cy - ch) / (fy + 1e-7)
    return torch.stack([root_x, root_y, depth], dim=1)[:, None, :]
