"""ResNet-50 trunk (port of ``pdfnet_tpu/models/resnet.py``, NCHW inside).

Returns the post-stem feature (before the max-pool) and the four stage
outputs, as the JAX module does.  Blocks are named ``layer{i}_{b}`` after the
flax tree.  The norms keep the compute dtype at train time, as the flax
ones do (``dtype=self.dtype``).

``fused_eval`` (``Config.fused_trunk``) routes the stride-1 bottlenecks of
width >= 128 in stages 1-3 (``layer2_1..3``, ``layer3_1..5``) through
``ops.trunk.fused_bottleneck`` at eval, as the JAX module does
(``resnet.py:150-179``): BatchNorm folded from the same parameters on each
call, so the ``state_dict`` is unchanged.  The trunk then runs in
``torch.channels_last``, so the fused blocks read and write NHWC views of its
maps with no copies; training keeps the unfused blocks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch.models.layers import bn, conv
from pdfnet_tpu_torch.ops.trunk import fold_bottleneck, fused_bottleneck


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        out_ch = width * 4
        self.project = project
        self.conv1 = conv(cin, width, 1)
        self.bn1 = bn(width, keep_dtype=True)
        self.conv2 = conv(width, width, 3, stride)
        self.bn2 = bn(width, keep_dtype=True)
        self.conv3 = conv(width, out_ch, 1)
        self.bn3 = bn(out_ch, keep_dtype=True)
        if project:
            self.proj_conv = conv(cin, out_ch, 1, stride)
            self.proj_bn = bn(out_ch, keep_dtype=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.proj_bn(self.proj_conv(x)) if self.project else x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """ResNet-v1 with bottleneck blocks (ResNet-50 at the default sizes)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 fused_eval: bool = False):
        super().__init__()
        self.fused_eval = fused_eval
        self.conv1 = conv(3, 64, 7, 2, padding=3)
        self.bn1 = bn(64, keep_dtype=True)
        self.block_names = []
        self.fusable = set()
        cin = 64
        for i, (n_blocks, w) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                name = f"layer{i + 1}_{b}"
                self.add_module(name, Bottleneck(cin, w, stride, project=b == 0))
                names.append(name)
                if stride == 1 and w >= 128 and i < 3:
                    self.fusable.add(name)
                cin = w * 4
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        fuse = self.fused_eval and not self.training
        if fuse:
            x = x.contiguous(memory_format=torch.channels_last)
        stem = F.relu(self.bn1(self.conv1(x)))             # (B, 64, H/2, W/2)
        y = F.max_pool2d(stem, 3, stride=2, padding=1)
        outs = []
        for names in self.block_names:
            for name in names:
                block = getattr(self, name)
                if fuse and name in self.fusable:
                    nhwc = y.permute(0, 2, 3, 1).contiguous()
                    y = fused_bottleneck(nhwc, fold_bottleneck(block), 1,
                                         block.project).permute(0, 3, 1, 2)
                else:
                    y = block(y)
            outs.append(y)
        return (stem, *outs)                                # stem, layer1..4
