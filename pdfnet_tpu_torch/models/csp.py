"""CSP alternate detector (port of ``pdfnet_tpu/models/csp.py``; reference
lib/models/networks/resnet_csp.py:229-557 ``PoseResNet``, EncodeUV
``:181-227``): the ``--arch csp_50|csp_18`` path, which regresses 122-d MANO
parameters per pixel from the center features.

- RGB-D input: depth is a fourth input channel;
- with ``use_heatmaps`` a ResNet-18 ``backbone`` feeds the uv-prior decoder
  (``UVDecoder``, 21 joint channels at /2); its 15 relation sums and the
  backbone's stem are reduced to 64 channels, which the ``trunk`` takes
  after its stem (``skip_stem``);
- ResNet-50 (bottleneck) or ResNet-18 (basic) trunk, FPN p3/p4/p5 to /4 with
  ``L2Norm``, concat, a 3x3 ``feat`` conv, ``feat_bn`` (flax momentum 0.99)
  and a ReLU;
- heads in ``sorted`` order (``hm`` bias -4.59); the one ``params`` head is
  applied ``iterations`` times to ``concat(feat, theta)`` from a zero theta
  and returns the list of thetas (``csp.py:165-180``).

Dtypes under ``compute_dtype="bfloat16"`` follow the flax module's: the
convs and the ResNet norms in bf16 (autocast), ``ConvBNBlock``'s norm and
``feat_bn`` in float32, so ``feat`` and every theta are float32 and the
other heads bf16.  Outputs are NHWC, as the JAX module returns them.
Module names follow the flax tree, so ``convert.from_flax`` maps a JAX
checkpoint with no rule of its own.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.encoder import _IS_HM
from pdfnet_tpu_torch.models.handnet import (compute_dtype, init_weights,
                                             resolve_device)
from pdfnet_tpu_torch.models.layers import (CenterHead, L2Norm, StridedUpConv,
                                            bn, conv)
from pdfnet_tpu_torch.models.resnet import ResNet
from pdfnet_tpu_torch.ops.heatmap import clamped_sigmoid

# Widths of the ResNet-18 backbone's stages, deepest first, which the uv
# decoder upsamples and concatenates (JAX ``csp.py:125``).
UV_LATENT = (512, 256, 128, 64)
# Width of the FPN outputs, ``feat`` and the heads' input (``csp.py:102``).
FEATURE_DIM = 256

# Joint-group relations whose uv-prior channels are summed into extra
# conditioning channels (resnet_csp.py:259).
RELATIONS = [[4, 8], [4, 12], [4, 16], [4, 20], [8, 12], [8, 16], [8, 20],
             [12, 16], [12, 20], [16, 20], [1, 2, 3, 4], [5, 6, 7, 8],
             [9, 10, 11, 12], [13, 14, 15, 16], [17, 18, 19, 20]]


class ConvBNBlock(nn.Module):
    """conv (with bias) -> float32 BatchNorm -> optional ReLU (JAX
    ``ConvBNBlock``, ``csp.py:46-65``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
        self.conv = conv(cin, features, kernel, bias=True)
        self.bn = bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(x))
        return F.relu(y) if self.use_relu else y


class UVDecoder(nn.Module):
    """The uv-heatmap prior decoder (resnet_csp.py:264-270, 382-391): four
    2x bilinear upsamples from the deepest feature, each but the last
    concatenated with the next shallower one, each followed by a
    ``ConvBNBlock``; then a 3x3 head and the clamped sigmoid over 21 joint
    channels.

    ``jax.image.resize(..., "bilinear")`` samples at half-pixel centres and
    renormalizes its weights at the edges; for an exact 2x upsample that is
    ``F.interpolate(align_corners=False)``, which clamps there to the same
    values (the port's ``ops.resize`` is ``align_corners=True`` and would
    not do)."""

    def __init__(self):
        super().__init__()
        latent = UV_LATENT
        widths = (latent[1], latent[2], latent[3], latent[3])
        cin = latent[0]
        for i in range(4):
            skip = latent[i + 1] if i < 3 else 0
            self.add_module(f"delayer{i}", ConvBNBlock(cin + skip, widths[i]))
            cin = widths[i]
        self.uv_head = conv(cin, 21, 3, bias=True)

    def forward(self, z: List[torch.Tensor]) -> torch.Tensor:
        x = z[0]                                 # z = [x4, x3, x2, x1]
        for i in range(4):
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=False)
            if i < 3:
                x = torch.cat([x, z[i + 1]], 1)
            x = getattr(self, f"delayer{i}")(x)
        return clamped_sigmoid(self.uv_head(x))


class CSPNet(nn.Module):
    """The alternate RGB-D CenterNet with the iterative MANO-theta head."""

    def __init__(self, heads: Dict[str, int], arch: str = "csp_50",
                 use_heatmaps: bool = False, iterations: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        gd = FEATURE_DIM
        self.use_heatmaps = use_heatmaps
        self.iterations = iterations
        self.dtype = dtype
        basic = "50" not in arch
        block = "basic" if basic else "bottleneck"
        stages = (2, 2, 2, 2) if basic else (3, 4, 6, 3)
        c2, c3, c4 = (128, 256, 512) if basic else (512, 1024, 2048)
        if use_heatmaps:
            self.backbone = ResNet((2, 2, 2, 2), block="basic", in_ch=4)
            self.uv_decoder = UVDecoder()
            c0 = 64 + 21 + len(RELATIONS)
            self.reduce0 = ConvBNBlock(c0, c0)
            self.reduce1 = ConvBNBlock(c0, 128)
            self.reduce2 = ConvBNBlock(128, 64, kernel=1, use_relu=False)
            self.trunk = ResNet(stages, block=block, skip_stem=True)
        else:
            self.trunk = ResNet(stages, block=block, in_ch=4)
        # flax ConvTranspose 4x4/s2 padding="SAME" == torch padding 1 with
        # the kernel flipped (convert.from_flax flips it)
        self.p3 = nn.ConvTranspose2d(c2, gd, 4, stride=2, padding=1)
        self.p4 = StridedUpConv(c3, gd, 4)
        self.p5 = StridedUpConv(c4, gd, 8)
        for p in ("p3", "p4", "p5"):
            self.add_module(f"{p}_l2", L2Norm(gd))
        self.feat = conv(3 * gd, gd, 3)
        self.feat_bn = bn(gd, momentum=0.99)
        self.head_names = sorted(heads)
        for head in self.head_names:
            cin = gd + heads[head] if head == "params" else gd
            self.add_module(f"head_{head}", CenterHead(
                cin, heads[head],
                bias_init_value=-4.59 if _IS_HM(head) else 0.0))

    def forward(self, img: torch.Tensor,
                depth: torch.Tensor) -> Dict[str, Any]:
        """img (B, H, W, 3) normalized RGB and depth (B, H, W) or (B, H, W,
        1), NHWC as the JAX module takes them.  Returns the heads as NHWC
        maps, ``params`` as the list of the ``iterations`` thetas, and
        ``uv_prior`` (B, H/2, W/2, 21) with ``use_heatmaps``."""
        if depth.dim() == 3:
            depth = depth[..., None]
        x = torch.cat([img, depth.to(img.dtype)], -1).permute(0, 3, 1, 2)
        ret: Dict[str, Any] = {}
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            if self.use_heatmaps:
                z0, z1, z2, z3, z4 = self.backbone(x)
                uv = self.uv_decoder([z4, z3, z2, z1])
                ret["uv_prior"] = uv.permute(0, 2, 3, 1)
                # summed in the uv prior's dtype, as flax does
                rel = torch.stack([uv[:, r].sum(1) for r in RELATIONS],
                                  1).to(uv.dtype)
                y = self.reduce0(torch.cat([z0, uv, rel], 1))
                y = self.reduce2(self.reduce1(y))
                _, x1, x2, x3, x4 = self.trunk(y)
            else:
                _, x1, x2, x3, x4 = self.trunk(x)
            cat = torch.cat([self.p3_l2(self.p3(x2)), self.p4_l2(self.p4(x3)),
                             self.p5_l2(self.p5(x4))], 1)
            feat = F.relu(self.feat_bn(self.feat(cat)))       # float32
            for head in self.head_names:
                mod = getattr(self, f"head_{head}")
                if head != "params":
                    ret[head] = mod(feat).permute(0, 2, 3, 1)
                    continue
                # one module applied every iteration (flax reuses it), from
                # a zero theta; float32 theta + bf16 head output is float32
                B, _, H, W = feat.shape
                theta = feat.new_zeros(B, mod.conv1.out_channels, H, W)
                thetas = []
                for _ in range(self.iterations):
                    theta = theta + mod(torch.cat([feat, theta], 1))
                    thetas.append(theta.permute(0, 2, 3, 1))
                ret[head] = thetas
        return ret


def csp_from_config(cfg: Config) -> CSPNet:
    """``CSPNet`` of ``cfg``'s values (JAX ``build_csp_model``,
    ``csp.py:184-191``), with torch's default initialization."""
    return CSPNet(heads=dict(cfg.heads), arch=cfg.arch,
                  use_heatmaps=cfg.use_uv_prior,
                  iterations=3 if cfg.iterations else 1,
                  dtype=compute_dtype(cfg))


def build_csp_model(cfg: Config, device="cuda") -> CSPNet:
    """``csp_from_config(cfg)`` with random weights seeded by ``cfg.seed``
    (flax's initializers), in eval mode on ``device``: the card by default;
    raises without one."""
    device = resolve_device(device)
    model = csp_from_config(cfg)
    init_weights(model, cfg.seed)
    return model.to(device).eval()
