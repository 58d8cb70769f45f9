"""PointNet++ set abstraction with pyramid SFT image fusion
(port of ``pdfnet_tpu/models/pointnet.py``; reference PointNet_Plus,
intaghand_encoder.py:32-159).

Levels 1 and 2 dispatch on ``knn_method`` as the JAX module does
(``pointnet.py:123-171``):

- ``"pallas_sa"`` at eval on xyz clouds: ``ops.sa`` (grouping + BN-folded
  MLP + max-pool kernels on the card, their plain versions on the CPU);
- otherwise (training, another method, or clouds with normals,
  ``input_feature_num=6``, at eval too) ``ops.grouping`` groups
  (``"pallas_fused"``/``"pallas_sa"``: the fused K3/K4 kernels with custom
  backward passes, level 1 of clouds with normals excepted; ``"topk"`` /
  ``"pallas"``: the generic kNN + ball query + gather) and the unfolded
  ``PointMLP`` runs (live BatchNorm at train time) with a max over the k
  neighbours.

The generic branch selects on float32 xyz at both levels: the SFT promotes
the float32 points, and the level-2 rows concatenate float32 centers with
the MLP's float32 output (its BatchNorm is float32, as flax's).  Level 3 is
an ordinary Linear + BatchNorm + ReLU stack and a max over points.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pdfnet_tpu_torch.models.layers import BN_EPS, SFTLayer, bn
from pdfnet_tpu_torch.ops.gather import gather_pixels_2d
from pdfnet_tpu_torch.ops.grouping import group_points, group_points_level2
from pdfnet_tpu_torch.ops.sa import sa_level1, sa_level2

LEVEL1_MLP = (64, 64, 128)
LEVEL2_MLP = (128, 128, 256)
LEVEL3_MLP = (512, 512, 1024)


class PointMLP(nn.Module):
    """Per-point MLP: (Linear -> BatchNorm -> relu) x len(features)."""

    def __init__(self, cin: int, features: Sequence[int]):
        super().__init__()
        self.features = tuple(features)
        for i, f in enumerate(self.features):
            self.add_module(f"fc{i}", nn.Linear(cin, f))
            self.add_module(f"bn{i}", bn(f))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., C) -> (..., F_last)."""
        shape = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        for i in range(len(self.features)):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return x.reshape(*shape, -1)


def _fold_point_mlp(mlp: PointMLP) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """BN-folded (W (C_in, C_out), b) pairs of a PointMLP in eval mode.

    BatchNorm at eval is the per-channel affine (x - mean) * g/sigma + beta,
    so Linear + BN is Linear(W * g/sigma, (b - mean) * g/sigma + beta), with
    g * rsqrt(var + eps) in float32 as ``pointnet.py:54-70`` computes it.
    """
    folded = []
    for i in range(len(mlp.features)):
        fc, norm = getattr(mlp, f"fc{i}"), getattr(mlp, f"bn{i}")
        inv = (norm.weight.float() * torch.rsqrt(norm.running_var.float()
                                                 + BN_EPS))
        w = fc.weight.float().t() * inv[None, :]
        b = (fc.bias.float() - norm.running_mean.float()) * inv + norm.bias.float()
        folded.append((w, b))
    return folded


class PointNetPlus(nn.Module):
    """Two-hand set abstraction: points (B, 2, N, input_feature_num) (xyz,
    or xyz + normals), pyramid embeddings [(B, 3, H, W), (B, 64, H/2, W/2),
    (B, 256, H/4, W/4)], choose (B, 2, N) flat pixel indices -> (B, 2, 1024).
    Both hands fold into one batch axis.
    """

    def __init__(self, knn_k: int = 64, num_level1: int = 512,
                 num_level2: int = 128, ball_radius: float = 0.015,
                 ball_radius2: float = 0.04, input_feature_num: int = 3,
                 resolution: int = 384, emb_dims: Sequence[int] = (3, 64, 256),
                 compute_dtype: torch.dtype = torch.float32,
                 knn_method: str = "pallas_sa"):
        super().__init__()
        self.knn_method = knn_method
        self.knn_k = knn_k
        self.num_level1 = num_level1
        self.num_level2 = num_level2
        self.ball_radius = ball_radius
        self.ball_radius2 = ball_radius2
        self.resolution = resolution
        self.compute_dtype = compute_dtype
        c1, c2 = 3 + LEVEL1_MLP[-1], 3 + LEVEL2_MLP[-1]
        self.sft0 = SFTLayer(emb_dims[0], input_feature_num)
        self.sft1 = SFTLayer(emb_dims[1], c1)
        self.sft2 = SFTLayer(emb_dims[2], c2)
        self.mlp1 = PointMLP(input_feature_num, LEVEL1_MLP)
        self.mlp2 = PointMLP(c1, LEVEL2_MLP)
        self.mlp3 = PointMLP(c2, LEVEL3_MLP)

    def forward(self, points: torch.Tensor, emb: List[torch.Tensor],
                choose: torch.Tensor) -> torch.Tensor:
        res = self.resolution
        B, H, N = choose.shape
        choose = choose.long()
        nhwc = [e.permute(0, 2, 3, 1) for e in emb]
        fold = lambda t: t.reshape(B * H, *t.shape[2:])

        # level 0: condition raw xyz on full-res RGB features at the pixels
        pw_l0 = fold(gather_pixels_2d(nhwc[0], choose.reshape(B, H * N))
                     .reshape(B, H, N, -1))
        pts = self.sft0(fold(points), pw_l0)

        # pyramid pixel indices at 1/2 and 1/4 resolution: integer row/col
        # halving of the flat index (intaghand_encoder.py:125-128)
        c_half = (choose // res // 2) * (res // 2) + choose % res // 2
        c_quart = (choose // res // 4) * (res // 4) + choose % res // 4
        pw_l1 = fold(gather_pixels_2d(
            nhwc[1], c_half[:, :, :self.num_level1].reshape(B, -1))
            .reshape(B, H, self.num_level1, -1))
        pw_l2 = fold(gather_pixels_2d(
            nhwc[2], c_quart[:, :, :self.num_level2].reshape(B, -1))
            .reshape(B, H, self.num_level2, -1))

        S1, S2, k, method = (self.num_level1, self.num_level2, self.knn_k,
                             self.knn_method)
        # the fused kernels group xyz rows at level 1 (pointnet.py:128-133)
        use_sa = (method == "pallas_sa" and not self.training
                  and pts.shape[-1] == 3)
        if use_sa:
            x = sa_level1(pts.float(), _fold_point_mlp(self.mlp1), k, S1,
                          self.ball_radius, self.compute_dtype)
        else:
            grouped, _ = group_points(pts, k, S1, self.ball_radius, method)
            x = self.mlp1(grouped).amax(dim=2)
        x = torch.cat([pts[:, :S1, :3], x], dim=-1)
        x = self.sft1(x, pw_l1)

        if use_sa:
            x2 = sa_level2(x.float(), _fold_point_mlp(self.mlp2), k, S2,
                           self.ball_radius2, self.compute_dtype)
        else:
            grouped, _ = group_points_level2(x, S2, k, self.ball_radius2,
                                             self.compute_dtype, method)
            x2 = self.mlp2(grouped).amax(dim=2)
        x = torch.cat([x[:, :S2, :3], x2], dim=-1)
        x = self.sft2(x, pw_l2)

        x = self.mlp3(x).amax(dim=1)                              # (BH, 1024)
        return x.reshape(B, H, -1)
