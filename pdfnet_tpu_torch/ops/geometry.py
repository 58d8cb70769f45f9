"""Camera geometry on the eval path: projections and root lifting
(port of ``pdfnet_tpu/ops/geometry.py``).

The JAX versions run their products at ``Precision.HIGHEST``; here they are
float32 products, which stay float32 on the card because
``torch.backends.cuda.matmul.allow_tf32`` is off by default.
"""

from __future__ import annotations

import torch


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
