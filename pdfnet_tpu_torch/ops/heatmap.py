"""CenterNet heatmap decode: clamped sigmoid, NMS, per-image top-k and the
per-class top-1 (port of ``pdfnet_tpu/ops/heatmap.py``).  Maps are NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), 1e-4, 1 - 1e-4)


def heatmap_nms(heat: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Keep only local maxima: heat * (maxpool(heat) == heat).

    heat: (B, H, W, C).  The max-pool pads with -inf, like the JAX
    ``reduce_window``.
    """
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, stride=1,
                        padding=pad).permute(0, 2, 3, 1)
    return heat * (hmax == heat).to(heat.dtype)


def heatmap_topk(scores: torch.Tensor, k: int):
    """Per-image top-k over one heatmap channel (B, H, W) -> (scores,
    flat_inds, ys, xs), each (B, k); ys and xs float32.  Equal scores go to
    the lowest index first, as ``lax.top_k`` takes them (a stable
    descending sort; ``torch.topk`` states no tie order)."""
    B, H, W = scores.shape
    top, inds = torch.sort(scores.reshape(B, -1), dim=-1, descending=True,
                           stable=True)
    top, inds = top[:, :k], inds[:, :k]
    return (top, inds, (inds // W).to(torch.float32),
            (inds % W).to(torch.float32))


def decode_centers(hm: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Left/right hand center flat indices (B, 2) from a post-sigmoid
    (B, H, W, 2) heatmap.  ``argmax`` returns the first maximal index, the
    tie-break of ``lax.top_k(..., 1)``."""
    nms = heatmap_nms(hm, kernel)
    B, H, W, C = nms.shape
    return nms.permute(0, 3, 1, 2).reshape(B, C, H * W).argmax(dim=-1)
