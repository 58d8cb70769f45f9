"""Fused eval-mode ResNet bottleneck blocks (port of
``pdfnet_tpu/ops/pallas_trunk.py``): BatchNorm folded into the convolutions
and one whole block per kernel launch, the map read once and written once.

==================== ================================================ =======================
wrapper              replaces (pdfnet_tpu/ops/pallas_trunk.py)         source
==================== ================================================ =======================
fused_bottleneck     ``_block_kernel_s1`` :148 (stride 1) and          csrc/trunk_block.cu
                     ``_block_kernel_s2`` :198 (stride 2), both via
                     ``fused_bottleneck`` :267
==================== ================================================ =======================

The wrapper runs the plain version for a tensor on the CPU and launches the
kernel for a CUDA tensor, or raises: there is no fallback.  In bf16 at
stride 1 the kernel runs its tensor-core body, whose shape limits
``check_tc_shape`` names and whose rows per block ``rows_per_block``
chooses; in float32 at stride 1 its CUDA-core body, whose limits
``check_f32_shape`` names and whose tiles and clusters ``f32_plan``
chooses; stride 2 runs the first CUDA-core body.  ``launches``
counts kernel launches by stride (``fused_bottleneck_s1`` /
``fused_bottleneck_s2``); the plain version never touches it.

Maps are NHWC (the JAX layout): the trunk runs in ``torch.channels_last``
when it routes blocks here, so ``x.permute(0, 2, 3, 1)`` of its NCHW maps is
already contiguous and no block copies its input or output.

Rounding follows the TPU kernel, not the unfused block: weights in the
compute dtype (the map's dtype), biases float32, products accumulated in
float32; y1 = relu(. + b1), y2 = relu(. + b2), y3 = . + b3 and a projected
shortcut are each rounded to the compute dtype, and the output is
relu(y3 + shortcut) in the compute dtype (``pallas_trunk.py:167-180,
224-236``).  The 3x3 pads conv2's input (after conv1 + BN + ReLU) with zeros;
stride 2 sits on the 3x3 and on the projection.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from pdfnet_tpu_torch.models.layers import BN_EPS
from pdfnet_tpu_torch.ops import cuda_build
from pdfnet_tpu_torch.ops.sa import MAX_SMEM, _check, _check_cuda, _stream

launches: Dict[str, int] = {"fused_bottleneck_s1": 0,
                            "fused_bottleneck_s2": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"fused_bottleneck": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _P]}
CHANNEL_MULTIPLE = 32    # csrc/trunk_block.cu: depth of a staged chunk
# csrc/trunk_block.cu's tensor-core body (bf16, stride 1): Cin a multiple of
# its chunk depth, Cw of its narrowest pass, passes of TC_ROWS rows; its
# shared memory (tc_smem_bytes) within the H100's 227 KB a block
TC_CIN_MULTIPLE, TC_CW_MULTIPLE, TC_ROWS = 64, 128, 48
_TC_STAGES = 2 * (TC_ROWS * (64 + 8) + 64 * (4 * 64 + 8))
# csrc/trunk_block.cu's float32 stride-1 body (f32::): passes of 16 row
# groups x RM rows (one of F32_RM) by 128 columns, depth chunks of 16 in a
# 2-stage ring, each pixel's channels padded by 4 floats; Cin and each
# cluster block's share of Cw and Cout multiples of F32_CHANNELS
F32_RM, F32_GROUPS, F32_CHANNELS, F32_KC, F32_PAD = (4, 5, 6, 8, 9), 16, \
    128, 16, 4
_F32_STAGES = 2
_F32_XSTAGE = _F32_STAGES * F32_GROUPS * F32_RM[-1] * (F32_KC + 4)
H100_SMS = 132

Folded = Dict[str, torch.Tensor]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def fold_conv_bn(conv: torch.nn.Conv2d, norm) -> tuple:
    """Eval-mode BatchNorm folded into the (bias-free) conv before it, in
    float32 (``fold_conv_bn``, ``pallas_trunk.py:42-55``): (w (kh, kw, Cin,
    Cout), b (Cout,))."""
    inv = norm.weight.float() * torch.rsqrt(norm.running_var.float() + BN_EPS)
    w = conv.weight.float().permute(2, 3, 1, 0) * inv
    b = norm.bias.float() - norm.running_mean.float() * inv
    return w, b


def fold_bottleneck(block) -> Folded:
    """BN-folded weights of one ``models.resnet.Bottleneck``, keyed as
    ``fold_bottleneck`` (``pallas_trunk.py:58-69``): w1 (Cin, Cw), w2 (3, 3,
    Cw, Cw), w3 (Cw, Cout) and, when projected, wp (Cin, Cout); biases
    b1, b2, b3[, bp]."""
    w1, b1 = fold_conv_bn(block.conv1, block.bn1)
    w2, b2 = fold_conv_bn(block.conv2, block.bn2)
    w3, b3 = fold_conv_bn(block.conv3, block.bn3)
    out = {"w1": w1[0, 0], "b1": b1, "w2": w2, "b2": b2, "w3": w3[0, 0],
           "b3": b3}
    if block.project:
        wp, bp = fold_conv_bn(block.proj_conv, block.proj_bn)
        out["wp"], out["bp"] = wp[0, 0], bp
    return out


def _check_args(x: torch.Tensor, folded: Folded, stride: int, project: bool):
    if stride not in (1, 2) or (stride == 2 and not project):
        raise ValueError(f"fused_bottleneck: stride {stride}, project "
                         f"{project} (stride 2 is always projected)")
    B, H, W, Cin = x.shape
    Cw, Cout = folded["w1"].shape[1], folded["w3"].shape[1]
    if (folded["w1"].shape[0] != Cin or folded["w2"].shape != (3, 3, Cw, Cw)
            or (project and folded["wp"].shape != (Cin, Cout))
            or (not project and Cin != Cout)
            or (stride == 2 and (H % 2 or W % 2))):
        raise ValueError(f"fused_bottleneck: map {tuple(x.shape)} does not "
                         f"fit the weights (Cw {Cw}, Cout {Cout})")
    return B, H, W, Cin, Cw, Cout


def check_tc_shape(H: int, W: int, Cin: int, Cw: int, project: bool) -> None:
    """Raise ValueError, naming the limit, for a bf16 stride-1 block that
    the tensor-core body does not take (every block the trunk routes fits)."""
    if project:
        raise ValueError("fused_bottleneck: the bf16 stride-1 body takes "
                         "unprojected blocks only (project=True)")
    if Cin % TC_CIN_MULTIPLE or Cw % TC_CW_MULTIPLE:
        raise ValueError(f"fused_bottleneck: the bf16 stride-1 body needs Cin "
                         f"a multiple of {TC_CIN_MULTIPLE} and Cw of "
                         f"{TC_CW_MULTIPLE}; got Cin {Cin}, Cw {Cw}")
    if tc_smem_bytes(1, W, Cw) > MAX_SMEM:
        raise ValueError(f"fused_bottleneck: a row of width {W} at Cw {Cw} "
                         f"does not fit the bf16 stride-1 body's shared "
                         f"memory ({tc_smem_bytes(1, W, Cw)} > {MAX_SMEM})")


def tc_smem_bytes(rows: int, W: int, Cw: int) -> int:
    """Shared memory of the tensor-core body for ``rows`` output rows a
    block (``tc::smem_bytes``): bf16 y1 of rows + 2 halo'd rows with a zero
    column each side, y2, and the double-buffered x and weight chunks; each
    pixel's channels padded by 8."""
    return 2 * ((rows + 2) * (W + 2) * (Cw + 8) + rows * W * (Cw + 8)
                + _TC_STAGES)


def rows_per_block(B: int, H: int, W: int, Cin: int, Cw: int,
                   sms: int = H100_SMS) -> int:
    """Output rows a block of the tensor-core body takes: the count whose
    blocks, in waves of one per SM, cost the least, each block costed as its
    three products' multiply-adds with rows rounded up to whole passes of
    TC_ROWS (conv1 on the rows + 2 halo rows).  ResNet-50 at 384x384, batch
    8: 3 at layer2 (128 blocks), 2 at layer3 (96 blocks)."""
    def passes(m):
        return -(-m // TC_ROWS) * TC_ROWS

    best = None
    for rows in range(1, H + 1):
        if tc_smem_bytes(rows, W, Cw) > MAX_SMEM:
            break
        blocks = B * -(-H // rows)
        work = (passes(min(rows + 2, H) * W) * Cin * Cw
                + passes(rows * W) * (9 * Cw * Cw + Cw * 4 * Cw))
        cost = -(-blocks // sms) * work
        if best is None or cost < best[0]:
            best = (cost, rows)
    return best[1]


def check_f32_shape(H: int, W: int, Cin: int, Cw: int,
                    project: bool) -> None:
    """Raise ValueError, naming the limit, for a float32 stride-1 block that
    the CUDA-core body does not take (every block the trunk routes fits)."""
    if project:
        raise ValueError("fused_bottleneck: the float32 stride-1 body takes "
                         "unprojected blocks only (project=True)")
    if Cin % F32_CHANNELS or Cw % F32_CHANNELS:
        raise ValueError(f"fused_bottleneck: the float32 stride-1 body needs "
                         f"Cin and Cw multiples of {F32_CHANNELS}; got Cin "
                         f"{Cin}, Cw {Cw}")
    if H * W * Cin > 2 ** 31 - 1:
        raise ValueError(f"fused_bottleneck: a map of {H}x{W}x{Cin} is past "
                         f"the float32 stride-1 body's 32-bit offsets")
    tw = _f32_tile_widths(W)[-1]
    if f32_smem_bytes(1, tw, Cw) > MAX_SMEM:
        raise ValueError(f"fused_bottleneck: a tile of 1 x {tw} at Cw {Cw} "
                         f"does not fit the float32 stride-1 body's shared "
                         f"memory ({f32_smem_bytes(1, tw, Cw)} > {MAX_SMEM})")


def f32_pass_rows(M: int) -> tuple:
    """(passes, RM) of the float32 body for a product of M rows
    (``f32::passes_of``, ``f32::rm_of``): the fewest passes of at most 16 x
    9 rows, and the smallest of F32_RM rows a thread that covers one."""
    passes = -(-M // (F32_GROUPS * F32_RM[-1]))
    need = -(-M // (F32_GROUPS * passes))
    return passes, min(r for r in F32_RM if r >= need)


def f32_smem_bytes(rows: int, tile_w: int, Cw: int) -> int:
    """Shared memory of the float32 body for a tile of ``rows`` x ``tile_w``
    output pixels (``f32::smem_bytes``): float32 y1 of the halo'd window
    (rows + 2, tile_w + 2), y2 (or, while conv1 runs, the staged x chunks,
    whichever is larger), the weight ring; channels padded by 4."""
    cs = Cw + F32_PAD
    return 4 * ((rows + 2) * (tile_w + 2) * cs
                + max(rows * tile_w * cs, _F32_XSTAGE)
                + _F32_STAGES * F32_KC * F32_CHANNELS)


def _f32_tile_widths(W: int) -> list:
    return sorted({-(-W // d) for d in (1, 2, 3, 4)}, reverse=True)


def f32_plan(B: int, H: int, W: int, Cin: int, Cw: int,
             sms: int = H100_SMS) -> tuple:
    """(rows, tile_w, cluster) of the float32 body: the tile of rows x
    tile_w output pixels (tile_w the width or a half, third or quarter of
    it, halo columns recomputed) on clusters of 1 or 2 blocks (each a half
    of the channels, where 128 divides the halves) whose blocks, in waves of
    one per SM, cost the least; a block costed as its three products'
    multiply-adds with rows rounded up to whole passes (``f32_pass_rows``).
    ResNet-50 at 384x384, batch 8: layer2 (3, 48, 1), 128 blocks; layer3
    (3, 24, 2), 128 blocks."""
    def slots(m):
        passes, rm = f32_pass_rows(m)
        return passes * F32_GROUPS * rm

    best = None
    for cs in (1, 2):
        if (Cw // cs) % F32_CHANNELS or (Cin // cs) % F32_CHANNELS:
            continue
        for tw in _f32_tile_widths(W):
            for rows in range(1, H + 1):
                if f32_smem_bytes(rows, tw, Cw) > MAX_SMEM:
                    break
                m1 = min(rows + 2, H) * min(tw + 2, W)
                m2 = rows * tw
                work = (slots(m1) * Cin + slots(m2) * 9 * Cw
                        + slots(m2) * Cin) * (Cw // cs)
                blocks = B * -(-H // rows) * -(-W // tw) * cs
                cost = -(-blocks // sms) * work
                if best is None or cost < best[0]:
                    best = (cost, (rows, tw, cs))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_bottleneck_plain(x: torch.Tensor, folded: Folded, stride: int = 1,
                           project: bool = False) -> torch.Tensor:
    """Plain version of ``fused_bottleneck`` with the kernel's rounding
    points: x (B, H, W, Cin) NHWC in the compute dtype -> (B, H/stride,
    W/stride, Cout) of x's dtype.  Rounding an operand to the compute dtype
    and multiplying in float32 is a product in that dtype with a float32
    accumulator (a bf16 x bf16 product is exact in float32)."""
    _check_args(x, folded, stride, project)
    cdt = x.dtype
    rnd = lambda t: t.to(cdt).float()
    with torch.autocast(x.device.type, enabled=False):
        xf = x.float()
        y1 = rnd(torch.relu(xf @ rnd(folded["w1"]) + folded["b1"].float()))
        y2 = F.conv2d(y1.permute(0, 3, 1, 2),
                      rnd(folded["w2"]).permute(3, 2, 0, 1), stride=stride,
                      padding=1).permute(0, 2, 3, 1)
        y2 = rnd(torch.relu(y2 + folded["b2"].float()))
        y3 = rnd(y2 @ rnd(folded["w3"]) + folded["b3"].float())
        xs = xf[:, ::stride, ::stride]
        sc = (rnd(xs @ rnd(folded["wp"]) + folded["bp"].float()) if project
              else xs)
        return torch.relu(y3 + sc).to(cdt)


def fused_bottleneck(x: torch.Tensor, folded: Folded, stride: int = 1,
                     project: bool = False) -> torch.Tensor:
    """One whole bottleneck block: x (B, H, W, Cin) NHWC float32 or bfloat16
    (the compute dtype) -> (B, H/stride, W/stride, Cout) of x's dtype."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, folded, stride, project)
    _check_cuda(x, "fused_bottleneck", (torch.float32, torch.bfloat16))
    B, H, W, Cin, Cw, Cout = _check_args(x, folded, stride, project)
    if Cin % CHANNEL_MULTIPLE or Cw % CHANNEL_MULTIPLE:
        raise ValueError(f"fused_bottleneck: Cin {Cin} and Cw {Cw} must be "
                         f"multiples of {CHANNEL_MULTIPLE}")
    rows, tile_w, cluster = 0, 0, 0     # the stride-2 body's own
    if x.dtype == torch.bfloat16 and stride == 1:
        check_tc_shape(H, W, Cin, Cw, project)
        rows = rows_per_block(B, H, W, Cin, Cw, _sm_count(x.device))
    elif stride == 1:
        check_f32_shape(H, W, Cin, Cw, project)
        rows, tile_w, cluster = f32_plan(B, H, W, Cin, Cw,
                                         _sm_count(x.device))
    names = ("w1", "b1", "w2", "b2", "w3", "b3") + (("wp", "bp") if project
                                                     else ())
    params = {}
    for n in names:
        t = folded[n]
        if t.device != x.device:
            raise ValueError("fused_bottleneck: weights on another device")
        params[n] = (t.float() if n.startswith("b") else t.to(x.dtype)
                     ).contiguous()
    out = torch.empty((B, H // stride, W // stride, Cout), dtype=x.dtype,
                      device=x.device)
    lib = cuda_build.library("trunk_block.cu", _SIGS)
    ptr = lambda n: params[n].data_ptr() if n in params else None
    _check(lib.fused_bottleneck(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, H, W, Cin, Cw, Cout,
        stride, int(project), ptr("w1"), ptr("b1"), ptr("w2"), ptr("b2"),
        ptr("w3"), ptr("b3"), ptr("wp"), ptr("bp"), out.data_ptr(), rows,
        tile_w, cluster, _stream()), "fused_bottleneck")
    launches[f"fused_bottleneck_s{stride}"] += 1
    return out
