"""crop_and_resize: TF-style bilinear box crop with its own backward (port of
``pdfnet_tpu/ops/crop_resize.py``, whose custom VJP this
``torch.autograd.Function`` reproduces).

The forward samples each output pixel bilinearly inside a normalized box;
samples outside the image take ``extrapolation_value``.  The backward
scatters the output gradient to the four source taps of each sample with
one ``index_add_`` over the image's pixel rows, so boxes that share an
image add up.  The boxes and their batch indices get no gradient, as in
JAX.  Plain gathers and scatters: the JAX function is plain XLA (no Pallas
kernel), and no JAX path calls it.
"""

from __future__ import annotations

import torch


def _sample_coords(boxes: torch.Tensor, crop_h: int, crop_w: int, H: int,
                   W: int):
    """Source rows (N, crop_h) and columns (N, crop_w) of the samples."""
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    ah = torch.arange(crop_h, device=boxes.device, dtype=boxes.dtype)
    aw = torch.arange(crop_w, device=boxes.device, dtype=boxes.dtype)
    if crop_h > 1:
        hs = (y2 - y1) * (H - 1) / (crop_h - 1)
        ys = y1[:, None] * (H - 1) + hs[:, None] * ah
    else:
        ys = 0.5 * (y1 + y2)[:, None] * (H - 1) * torch.ones_like(ah)[None]
    if crop_w > 1:
        ws = (x2 - x1) * (W - 1) / (crop_w - 1)
        xs = x1[:, None] * (W - 1) + ws[:, None] * aw
    else:
        xs = 0.5 * (x1 + x2)[:, None] * (W - 1) * torch.ones_like(aw)[None]
    return ys, xs


def _taps(boxes: torch.Tensor, box_ind: torch.Tensor, crop_h: int,
          crop_w: int, H: int, W: int):
    """The rows of each sample's four taps in the (B * H * W, C) image, (4,
    N, ch, cw) in the order top-left, top-right, bottom-left,
    bottom-right; the fractions fy (N, ch, 1, 1) and fx (N, 1, cw, 1); the
    in-image mask (N, ch, cw, 1)."""
    ys, xs = _sample_coords(boxes, crop_h, crop_w, H, W)
    valid = (((ys >= 0) & (ys <= H - 1))[:, :, None]
             & ((xs >= 0) & (xs <= W - 1))[:, None, :])[..., None]
    y0 = torch.clamp(torch.floor(ys), 0, H - 1).long()
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1).long()
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    fy = (ys - y0)[:, :, None, None]
    fx = (xs - x0)[:, None, :, None]
    base = box_ind.long()[:, None, None] * H
    rows = torch.stack([(base + yi[:, :, None]) * W + xi[:, None, :]
                        for yi in (y0, y1) for xi in (x0, x1)])
    return rows, fy, fx, valid


class _CropAndResize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, image, boxes, box_ind, crop_h, crop_w,
                extrapolation_value):
        B, H, W, C = image.shape
        rows, fy, fx, valid = _taps(boxes, box_ind, crop_h, crop_w, H, W)
        t = image.reshape(B * H * W, C)[rows]            # (4, N, ch, cw, C)
        top = t[0] * (1 - fx) + t[1] * fx
        bot = t[2] * (1 - fx) + t[3] * fx
        out = top * (1 - fy) + bot * fy
        ctx.save_for_backward(boxes, box_ind)
        ctx.shape, ctx.crop = image.shape, (crop_h, crop_w)
        return torch.where(valid, out, torch.full_like(out,
                                                       extrapolation_value))

    @staticmethod
    def backward(ctx, g):
        boxes, box_ind = ctx.saved_tensors
        B, H, W, C = ctx.shape
        crop_h, crop_w = ctx.crop
        rows, fy, fx, valid = _taps(boxes, box_ind, crop_h, crop_w, H, W)
        g = torch.where(valid, g, torch.zeros_like(g))
        w = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                         fy * (1 - fx), fy * fx])        # (4, N, ch, cw, 1)
        grad = g.new_zeros(B * H * W, C)
        grad.index_add_(0, rows.reshape(-1), (g * w).reshape(-1, C))
        return grad.reshape(ctx.shape), None, None, None, None, None


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    box_ind: torch.Tensor, crop_h: int, crop_w: int,
                    extrapolation_value: float = 0.0) -> torch.Tensor:
    """Crop boxes out of images and resize them bilinearly to (crop_h,
    crop_w).  image (B, H, W, C), boxes (N, 4) normalized [y1, x1, y2, x2],
    box_ind (N,) the image of each box; returns (N, crop_h, crop_w, C)."""
    return _CropAndResize.apply(image, boxes, box_ind, crop_h, crop_w,
                                extrapolation_value)
