"""Image encoder: ResNet-50 FPN + CenterNet heads + hms/mask decoders +
center-feature conditioning + PointNet++ fusion (port of
``pdfnet_tpu/models/encoder.py``; reference ResNetSimple,
intaghand_encoder.py:567-819, and resnet_mid, :822-882).

NCHW inside.  ``forward`` is the JAX ``mode="full"``; ``image_phase`` and
``point_phase`` are its ``mode="image"`` / ``mode="point"`` split
(``encoder.py:58-77,167-174``), between which the self-contained RGB-D path
builds the clouds from the predicted mask.  ``aux=False`` skips what the
eval outputs never read (the hms/mask decoders and every head but ``hm``):
the JAX eval step drops the same work by dead-code elimination under
``jit``.  ``need_mask`` keeps the mask decoder for the cloud builder.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch.models.layers import (CenterHead, ConvActBN, L2Norm,
                                            PyramidDecoder, SFTLayer,
                                            StridedUpConv, bn, conv)
from pdfnet_tpu_torch.models.pointnet import PointNetPlus
from pdfnet_tpu_torch.models.resnet import ResNet
from pdfnet_tpu_torch.ops.gather import gather_patches
from pdfnet_tpu_torch.ops.heatmap import clamped_sigmoid, decode_centers

_IS_HM = lambda h: "hm" in h or "heatmap" in h or "handmap" in h


class FPNEncoder(nn.Module):
    def __init__(self, heads: Dict[str, int], fmap_dim: int = 128,
                 global_feature_dim: int = 256, heatmap_dim: int = 21,
                 hand_num: int = 2, resolution: int = 384, knn_k: int = 64,
                 num_level1: int = 512, num_level2: int = 128,
                 ball_radius: float = 0.015, ball_radius2: float = 0.04,
                 input_feature_num: int = 3,
                 raw_center_decode: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 knn_method: str = "pallas_sa", fused_trunk: bool = False):
        super().__init__()
        gd = global_feature_dim
        self.raw_center_decode = raw_center_decode
        self.e_conv1 = conv(3, 3, 3)
        self.resnet = ResNet(fused_eval=fused_trunk)
        self.p2 = conv(256, gd, 3, bias=True)
        # flax ConvTranspose 4x4/s2 padding="SAME" == torch padding 1 with
        # the kernel flipped (convert.from_flax flips it)
        self.p3 = nn.ConvTranspose2d(512, gd, 4, stride=2, padding=1)
        self.p4 = StridedUpConv(1024, gd, 4)
        self.p5 = StridedUpConv(2048, gd, 8)
        for p in ("p2", "p3", "p4", "p5"):
            self.add_module(f"{p}_l2", L2Norm(gd))
        self.feat = conv(4 * gd, gd, 3)
        self.feat_bn = bn(gd)
        self.head_names = sorted(heads)
        for head in self.head_names:
            self.add_module(f"head_{head}", CenterHead(
                gd, heads[head], bias_init_value=-4.59 if _IS_HM(head) else 0.0))
        self.hms_decoder = PyramidDecoder(2048, fmap_dim,
                                          heatmap_dim * hand_num)
        self.dp_decoder = PyramidDecoder(2048, fmap_dim, hand_num,
                                         up_scale=True)
        self.center_up0 = conv(gd, 512, 3, padding=0)
        self.center_up1 = conv(512, 1024, 3, padding=0)
        self.pointnet = PointNetPlus(
            knn_k=knn_k, num_level1=num_level1, num_level2=num_level2,
            ball_radius=ball_radius, ball_radius2=ball_radius2,
            input_feature_num=input_feature_num, resolution=resolution,
            emb_dims=(3, 64, gd), compute_dtype=compute_dtype,
            knn_method=knn_method)
        self.sft = SFTLayer(1024, 1024)

    def forward(self, img: torch.Tensor, cloud: torch.Tensor,
                choose: torch.Tensor, ind: Optional[torch.Tensor] = None,
                aux: bool = True):
        """img (B, 3, H, W) normalized RGB, cloud (B, 2, N, 3 or 6), choose
        (B, 2, N), ind (B, 2) the hand centers' flat indices (the ground
        truth at train time) or None to decode them from the predicted
        heatmap, as the JAX module does at test time.

        Returns (hms, mask, ret, ind, img_fmaps, hms_fmaps, dp_fmaps) like the
        JAX module; with ``aux=False`` hms, mask and both fmaps lists are
        None and ``ret`` holds only the heatmap heads.
        """
        hms, mask, ret, ind, cached = self.image_phase(img, ind, aux)
        fuse = self.point_phase(cached, cloud, choose, ind)
        return (hms, mask, ret, ind, [fuse, cached["x2"], cached["x3"],
                                      cached["x4"]],
                cached["hms_fmaps"], cached["dp_fmaps"])

    def image_phase(self, img: torch.Tensor, ind: Optional[torch.Tensor] = None,
                    aux: bool = True, need_mask: bool = False):
        """Trunk, FPN, heads, center decode and decoders (``mode="image"``).

        Returns (hms, mask, ret, ind, cached); ``cached`` holds x0, the
        pyramid embeddings ``pw_emb``, the trunk stages x2..x4 and the
        decoder pyramids (None where skipped).  ``aux=False`` skips the
        decoders and the non-hm heads, ``need_mask`` then still runs the mask
        decoder (hms and its pyramid stay None).
        """
        pw_l0 = F.relu(self.e_conv1(img))
        stem, x4, x3, x2, x1 = self.resnet(img)

        p2 = self.p2_l2(self.p2(x4))
        p3 = self.p3_l2(self.p3(x3))
        p4 = self.p4_l2(self.p4(x2))
        p5 = self.p5_l2(self.p5(x1))
        x0 = F.relu(self.feat_bn(self.feat(torch.cat([p2, p3, p4, p5], 1))))

        ret = {h: getattr(self, f"head_{h}")(x0) for h in self.head_names
               if aux or _IS_HM(h)}
        if ind is None:
            hm = ret["hm"].detach().permute(0, 2, 3, 1)
            ind = decode_centers(hm if self.raw_center_decode
                                 else clamped_sigmoid(hm))

        hms = mask = hms_fmaps = dp_fmaps = None
        if aux:
            hms, hms_fmaps = self.hms_decoder(x1)
        if aux or need_mask:
            mask, dp_fmaps = self.dp_decoder(x1)
        cached = dict(x0=x0, pw_emb=[pw_l0, stem, x0], x2=x2, x3=x3, x4=x4,
                      hms_fmaps=hms_fmaps, dp_fmaps=dp_fmaps)
        return hms, mask, ret, ind, cached

    def point_phase(self, cached, cloud: torch.Tensor, choose: torch.Tensor,
                    ind: torch.Tensor) -> torch.Tensor:
        """Center features at the two hand centers + PointNet++ fusion from
        ``image_phase``'s cache (``mode="point"``): the fused (B, 2, 1024)
        point feature."""
        x0 = cached["x0"]
        B, gd, H0, W0 = x0.shape
        # 5x5 input patches around each center stand in for the full-map
        # 3x3 convs (VALID on the zero-padded map, the same sums)
        p = gather_patches(x0.permute(0, 2, 3, 1), ind, 5)   # (B, 2, 5, 5, gd)
        p = p.reshape(B * 2, 5, 5, gd).permute(0, 3, 1, 2)
        up0 = self.center_up0(p)                              # (2B, 512, 3, 3)
        # the reference's second conv sees its own zero padding outside the
        # map, not values computed from the zero-extended patch
        yc = (ind // W0).reshape(B * 2).long()
        xc = (ind % W0).reshape(B * 2).long()
        off = torch.arange(-1, 2, device=x0.device)
        rows_ok = ((yc[:, None] + off) >= 0) & ((yc[:, None] + off) < H0)
        cols_ok = ((xc[:, None] + off) >= 0) & ((xc[:, None] + off) < W0)
        inmap = rows_ok[:, :, None] & cols_ok[:, None, :]     # (2B, 3, 3)
        up0 = up0 * inmap[:, None].to(up0.dtype)
        center_feat = self.center_up1(up0).reshape(B, 2, 1024)

        fuse = self.pointnet(cloud, cached["pw_emb"], choose)  # (B, 2, 1024)
        return self.sft(fuse, center_feat)


class MidFusion(nn.Module):
    """Fuse the hms/mask decoder pyramids (+ trunk stages) into decoder fmaps
    and split the fused point feature into per-hand global features."""

    def __init__(self, in_dims: Sequence[int],
                 out_dims: Sequence[int] = (256, 256, 256, 256)):
        super().__init__()
        for i, (cin, cout) in enumerate(zip(in_dims, out_dims)):
            self.add_module(f"conv{i}", ConvActBN(cin, cout, kernel=1))
        self.n = len(out_dims)

    def forward(self, img_fmaps: List[torch.Tensor],
                hms_fmaps: Optional[List[torch.Tensor]],
                dp_fmaps: Optional[List[torch.Tensor]]):
        """Returns (gf_left, gf_right, fmaps); fmaps is None when the decoder
        pyramids were skipped (``aux=False``)."""
        gf_left, gf_right = img_fmaps[0][:, 0], img_fmaps[0][:, 1]
        if hms_fmaps is None:
            return gf_left, gf_right, None
        fmaps = []
        for i in range(self.n):
            x = torch.cat([hms_fmaps[i], dp_fmaps[i]], dim=1)
            if i > 0:
                x = torch.cat([x, img_fmaps[i]], dim=1)
            fmaps.append(getattr(self, f"conv{i}")(x))
        return gf_left, gf_right, fmaps
