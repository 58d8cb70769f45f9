"""Shared building blocks (port of ``pdfnet_tpu/models/layers.py``).

Inside the modules image tensors are NCHW; token tensors are (B, N, C).
Module and parameter names follow the flax module tree, so
``convert.from_flax`` maps a JAX checkpoint by path.

References:
- SFTLayer:               intaghand_encoder.py:205-219
- L2Norm:                 intaghand_encoder.py:318-334
- conv1x1 (conv-act-bn):  intaghand_encoder.py:192-198
- ResNetSimple_decoder:   intaghand_encoder.py:270-316
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch.ops.resize import resize_bilinear_align_corners
from pdfnet_tpu_torch.parallel import mesh

LN_EPS = 1e-6     # every LayerNorm of the JAX model (flax default)
BN_EPS = 1e-5


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
         padding: int | None = None) -> nn.Conv2d:
    """flax ``nn.Conv`` with explicit (k//2) padding unless given."""
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=k // 2 if padding is None else padding, bias=bias)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of (N, C, ...) with flax's rules (``nn.BatchNorm``
    with ``epsilon=1e-5``, float32 statistics, flax ``momentum``: 0.9 unless
    given, 0.99 for the CSP detector's ``feat_bn``).

    - eval: the running statistics (``F.batch_norm``), in float32 unless
      ``keep_dtype``;
    - train: the batch's float32 (float64 for a float64 input: flax
      promotes the input's dtype to float32) mean and its biased variance
      ``max(E[x^2] - E[x]^2, 0)`` (flax's fast variance), normalized as
      ``(x - mean) * (rsqrt(var + eps) * weight) + bias``; the running
      statistics move by ``momentum * old + (1 - momentum) * new``, the
      biased variance included, where ``torch.nn.BatchNorm*`` would use the
      unbiased one (torch's ``momentum`` is 1 minus flax's);
    - ``frozen`` (``Config.freeze_bn_stats``): train-time normalization with
      the running statistics, which stay as they are; weight and bias train;
    - inside a distributed train step (``parallel.mesh.global_batch``) the
      batch statistics are the global batch's: the float32 sums and sums of
      squares are added over the ranks (with their gradient), so every rank
      normalizes and updates its running statistics as one process would
      on the whole batch.

    The output is float32, or the input's dtype with ``keep_dtype`` (the
    ResNet's norms, whose flax dtype is the compute dtype).
    """

    def __init__(self, c: int, keep_dtype: bool = False,
                 momentum: float = 0.9):
        super().__init__(c, eps=BN_EPS)
        self.keep_dtype = keep_dtype
        self.flax_momentum = momentum
        self.frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x if self.keep_dtype else x.float(),
                                self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.frozen:
            mean, var = self.running_mean, self.running_var
        else:
            dims = [0, *range(2, x.dim())]
            _, rows = mesh.batch_stripe(x.shape[0])
            if rows == x.shape[0]:
                mean = xf.mean(dims)
                sq = (xf * xf).mean(dims)
            else:
                # the global count: the batch's rows x each row's elements
                n = rows * (x.numel() // (x.shape[0] * x.shape[1]))
                sums = mesh.batch_sum(torch.stack([xf.sum(dims),
                                                   (xf * xf).sum(dims)]))
                mean, sq = sums[0] / n, sums[1] / n
            var = torch.clamp(sq - mean * mean, min=0.0)
            m = self.flax_momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype) if self.keep_dtype else y


def bn(c: int, keep_dtype: bool = False, momentum: float = 0.9) -> BatchNorm:
    return BatchNorm(c, keep_dtype, momentum)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: at train time each element is kept with
    probability 1 - p and scaled by 1 / (1 - p), else zeroed; the identity
    at eval or p == 0.  The draws come from ``generator``, a
    ``torch.Generator`` on the input's device that ``HandNet.forward`` sets
    for each call (the default generator when none is set).  Inside a
    distributed train step (``parallel.mesh.global_batch``) every rank draws
    the global batch's mask from the same generator and keeps its rows
    (``mesh.batch_stripe``): N ranks drop what one process would on the
    global batch, the ranks' stripes in rank order (the loader's striping
    puts the same records in another order than one process's batch).  The
    model peers of a 2-D layout draw from equal generators, so their masks
    agree."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        b = x.shape[0]
        first, rows = mesh.batch_stripe(b)
        u = torch.rand((rows,) + tuple(x.shape[1:]),
                       generator=self.generator,
                       device=x.device)[first:first + b]
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class SFTLayer(nn.Module):
    """Spatial feature transform on (B, N, C) tokens:
    fea * (scale(cond) + 1) + shift(cond)."""

    def __init__(self, cond_dim: int, fea_dim: int):
        super().__init__()
        self.scale0 = nn.Linear(cond_dim, cond_dim)
        self.scale1 = nn.Linear(cond_dim, fea_dim)
        self.shift0 = nn.Linear(cond_dim, cond_dim)
        self.shift1 = nn.Linear(cond_dim, fea_dim)

    def forward(self, fea: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale = self.scale1(F.leaky_relu(self.scale0(cond), 0.1))
        shift = self.shift1(F.leaky_relu(self.shift0(cond), 0.1))
        return fea * (scale + 1.0) + shift


class L2Norm(nn.Module):
    """Per-pixel channel L2 normalization (NCHW) with a learned per-channel
    gain; the norm is taken in float32 and 1e-10 is added after the sqrt."""

    def __init__(self, channels: int, scale_init: float = 10.0):
        super().__init__()
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.full((channels,), scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True)) + 1e-10
        return x / norm.to(x.dtype) * self.weight.to(x.dtype)[None, :, None, None]


def depth_to_space(y: torch.Tensor, f: int, features: int) -> torch.Tensor:
    """(B, H, W, f*f*C) -> (B, H*f, W*f, C), channel chunk (a*f+b) landing at
    output pixel (h*f+a, w*f+b)."""
    B, H, W, _ = y.shape
    y = y.reshape(B, H, W, f, f, features)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(B, H * f, W * f, features)


class StridedUpConv(nn.Module):
    """ConvTranspose with kernel == stride as one matmul + depth-to-space.

    ``weight`` has the torch ConvTranspose2d layout (cin, features, f, f):
    output pixel (h*f+a, w*f+b) takes x[h, w] @ weight[:, :, a, b].  The flax
    module stores the spatially flipped kernel (``convert.from_flax`` flips).
    """

    def __init__(self, cin: int, features: int, factor: int):
        super().__init__()
        self.factor = factor
        self.features = features
        self.weight = nn.Parameter(torch.empty(cin, features, factor, factor))
        self.bias = nn.Parameter(torch.zeros(features))

    def project(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """The NHWC output without the bias, for ``weight`` (cin, F, f, f)
        of any F (a slice of the output channels under tensor
        parallelism, ``parallel/mesh.py``)."""
        f = self.factor
        B, cin, H, W = x.shape
        feats = weight.shape[1]
        w = weight.permute(0, 2, 3, 1).reshape(cin, f * f * feats)
        y = x.permute(0, 2, 3, 1).reshape(B * H * W, cin) @ w.to(x.dtype)
        return depth_to_space(y.reshape(B, H, W, -1), f, feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(x, self.weight)
        return (y + self.bias.to(y.dtype)).permute(0, 3, 1, 2)


class ConvActBN(nn.Module):
    """conv -> relu -> batchnorm (the reference's conv1x1 block order)."""

    def __init__(self, cin: int, features: int, kernel: int = 1):
        super().__init__()
        self.conv = conv(cin, features, kernel)
        self.bn = bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(F.relu(self.conv(x)))


def _resize_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    y = resize_bilinear_align_corners(x.permute(0, 2, 3, 1), out_h, out_w)
    return y.permute(0, 3, 1, 2)


class PyramidDecoder(nn.Module):
    """Upsampling decoder from the /32 trunk feature: four conv-relu-bn
    stages (flat, up, up, up) collecting their maps, then a 1x1 head; with
    ``up_scale`` the head output is resized x4 (the mask path)."""

    def __init__(self, cin: int, fdim: int = 128, out_dim: int = 42,
                 up_scale: bool = False):
        super().__init__()
        self.up_scale = up_scale
        for i in range(4):
            k = 1 if i == 0 else 3
            self.add_module(f"stage{i}", conv(cin if i == 0 else fdim, fdim, k))
            self.add_module(f"bn{i}", bn(fdim))
        self.head = conv(fdim, out_dim, 1, bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fmaps = []
        for i in range(4):
            if i > 0:
                x = _resize_nchw(x, x.shape[2] * 2, x.shape[3] * 2)
            x = getattr(self, f"bn{i}")(F.relu(getattr(self, f"stage{i}")(x)))
            fmaps.append(x)
        y = self.head(x)
        if self.up_scale:
            # the 1x1 head commutes with the resizes; the JAX module runs it
            # first too (reference order: resize -> conv -> resize)
            H, W = x.shape[2], x.shape[3]
            y = _resize_nchw(y, H * 2, W * 2)
            y = _resize_nchw(y, H * 4, W * 4)
        return y, fmaps


class CenterHead(nn.Module):
    """Per-task head: 3x3 conv + relu + 1x1 conv; ``bias_init_value`` seeds
    the final bias (-4.59 for heatmap heads).

    ``patch=True`` applies the same weights to pre-gathered 3x3 input
    patches without padding: the SAME-padded full-map head's value at each
    patch's center (the patches carry the map's zero ring at its borders).
    """

    def __init__(self, cin: int, out_dim: int, mid_dim: int = 256,
                 bias_init_value: float = 0.0):
        super().__init__()
        self.bias_init_value = bias_init_value
        self.conv0 = conv(cin, mid_dim, 3, bias=True)
        self.conv1 = conv(mid_dim, out_dim, 1, bias=True)

    def forward(self, x: torch.Tensor, patch: bool = False) -> torch.Tensor:
        y = (F.conv2d(x, self.conv0.weight, self.conv0.bias) if patch
             else self.conv0(x))
        return self.conv1(F.relu(y))


class MLPResBlock(nn.Module):
    """LayerNorm -> fc -> relu -> dropout -> fc -> dropout residual block
    (self_attn.py:18-34)."""

    def __init__(self, dim: int, hid_dim: int, dropout: float = 0.1):
        super().__init__()
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, hid_dim)
        self.fc2 = nn.Linear(hid_dim, dim)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop1(F.relu(self.fc1(self.ln(x))))
        return x + self.drop2(self.fc2(y))
