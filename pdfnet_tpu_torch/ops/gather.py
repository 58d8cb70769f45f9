"""Feature gathering at flat pixel indices (port of ``pdfnet_tpu/ops/gather.py``).

Public functions keep the JAX layout: NHWC maps, (B, K) flat indices into the
row-major H*W grid.  A channels-last tensor's NCHW view permuted to NHWC is a
free view, so modules call these without copies.
"""

from __future__ import annotations

import torch


def gather_pixels_2d(fmap_nhwc: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) map, (B, K) flat indices -> (B, K, C), indexing by
    (row, col) so the map is never collapsed to (B, H*W, C)."""
    B, H, W, C = fmap_nhwc.shape
    ind = ind.long()
    b = torch.arange(B, device=fmap_nhwc.device)[:, None]
    return fmap_nhwc[b, ind // W, ind % W]


def gather_patches(fmap_nhwc: torch.Tensor, ind: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Zero-padded ``size x size`` windows centered at flat pixel indices.

    (B, H, W, C), (B, K) -> (B, K, size, size, C).  Equivalent to padding
    the map by size//2 and slicing, without materializing the padded copy:
    rows/cols outside the map are clamped for the read and zeroed after.
    """
    B, H, W, C = fmap_nhwc.shape
    r = size // 2
    ind = ind.long()
    off = torch.arange(size, device=fmap_nhwc.device) - r
    ry = (ind // W)[..., None] + off                          # (B, K, size)
    rx = (ind % W)[..., None] + off
    b = torch.arange(B, device=fmap_nhwc.device)[:, None, None, None]
    p = fmap_nhwc[b, ry.clamp(0, H - 1)[..., :, None],
                  rx.clamp(0, W - 1)[..., None, :]]           # (B, K, s, s, C)
    valid = (((ry >= 0) & (ry < H))[..., :, None]
             & ((rx >= 0) & (rx < W))[..., None, :])
    return torch.where(valid[..., None], p, torch.zeros((), dtype=p.dtype,
                                                        device=p.device))


def gather_pixels(fmap_nhwc: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) map, (B, K) flat indices into the row-major H*W grid ->
    (B, K, C)."""
    B, H, W, C = fmap_nhwc.shape
    b = torch.arange(B, device=fmap_nhwc.device)[:, None]
    return fmap_nhwc.reshape(B, H * W, C)[b, ind.long()]
