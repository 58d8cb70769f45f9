"""ResNet-50 trunk (port of ``pdfnet_tpu/models/resnet.py``, NCHW inside).

Returns the post-stem feature (before the max-pool) and the four stage
outputs, as the JAX module does.  Blocks are named ``layer{i}_{b}`` after the
flax tree.  The norms keep the compute dtype at train time, as the flax
ones do (``dtype=self.dtype``).  The JAX module's ``s2d_stem`` and
``fused_trunk`` variants are later work; both default to off.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch.models.layers import bn, conv


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

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, padding=3)
        self.bn1 = bn(64, keep_dtype=True)
        self.block_names = []
        cin = 64
        for i, (n_blocks, w) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                name = f"layer{i + 1}_{b}"
                self.add_module(name, Bottleneck(cin, w, stride, project=b == 0))
                names.append(name)
                cin = w * 4
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        stem = F.relu(self.bn1(self.conv1(x)))             # (B, 64, H/2, W/2)
        y = F.max_pool2d(stem, 3, stride=2, padding=1)
        outs = []
        for names in self.block_names:
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        return (stem, *outs)                                # stem, layer1..4
