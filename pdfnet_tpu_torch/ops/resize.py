"""Bilinear resize with ``align_corners=True`` semantics and nearest x2
upsampling (port of ``pdfnet_tpu/ops/resize.py``).

The resize is two small interpolation-matrix products (separable), the same
matrices the JAX package builds, so both packages round alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-interpolation matrix, align_corners=True."""
    W = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        W[:, 0] = 1.0
        return W
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    W[np.arange(n_out), lo] += 1.0 - frac
    W[np.arange(n_out), hi] += frac
    return W


@functools.lru_cache(maxsize=64)
def _interp_tensor(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``_interp_matrix`` on the device, made once: copying a host array to
    the card on every call waits for the stream, which would hold a serving
    step's host behind its device work.  Made outside inference mode, so
    training may save it for the backward pass."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(n_in, n_out)).to(device, dtype)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Resize (B, H, W, C) -> (B, out_h, out_w, C)."""
    B, H, W, C = x.shape
    Wh = _interp_tensor(H, out_h, x.device, x.dtype)
    Ww = _interp_tensor(W, out_w, x.device, x.dtype)
    y = torch.einsum("oh,bhwc->bowc", Wh, x)
    return torch.einsum("ow,bhwc->bhoc", Ww, y)


def upsample2x_nearest(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Nearest-neighbor x2 along one axis (graph vertex upsampling)."""
    return torch.repeat_interleave(x, 2, dim=axis)
