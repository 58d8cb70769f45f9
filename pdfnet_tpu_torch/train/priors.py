"""Pose/shape priors and the photometric-path loss terms (port of
``pdfnet_tpu/train/priors.py``).

References:
- NormLoss (lib/models/losses.py:492-525): per-joint axis-angle range
  priors (dataset-specific tables in degrees) + L2 shape prior.
- photometric/seg terms (simplified.py origforward): masked image
  difference, silhouette loss, PSNR metric.

The limit tables come from ``pdfnet_tpu/assets/pose_limits.npz``, read by
path (``assets.ASSET_DIR``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from pdfnet_tpu_torch.assets import ASSET_DIR
from pdfnet_tpu_torch.parallel import mesh

_LIMITS: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}


def pose_limits(table: str, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(45,) min / max axis-angle limits in radians, float32 on ``device``.

    ``table``: one of left / right / h2o_left / h2o_right (an unknown name
    takes ``left``, as the JAX function does).
    """
    if table not in _LIMITS:
        with np.load(os.path.join(ASSET_DIR, "pose_limits.npz")) as z:
            deg = z[table] if table in z.files else z["left"]
        rad = deg / 180.0 * math.pi
        _LIMITS[table] = (rad[:, 0].astype(np.float32),
                          rad[:, 1].astype(np.float32))
    lo, hi = _LIMITS[table]
    return (torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device))


def pose_shape_prior_loss(pose_l: torch.Tensor, pose_r: torch.Tensor,
                          shape_l: torch.Tensor, shape_r: torch.Tensor,
                          dataset: str = "H2O") -> torch.Tensor:
    """NormLoss: clamp-outside-range pose prior + 0.1 * L2 shape prior.

    pose_*: (B, 45) axis-angle; shape_*: (B, 10).  Returns (B,).
    """
    tl = "h2o_left" if dataset == "H2O" else "left"
    tr = "h2o_right" if dataset == "H2O" else "right"
    lmin, lmax = pose_limits(tl, pose_l.device)
    rmin, rmax = pose_limits(tr, pose_r.device)
    pose = ((lmin - pose_l).clamp_min(0) + (pose_l - lmax).clamp_min(0) +
            (rmin - pose_r).clamp_min(0) + (pose_r - rmax).clamp_min(0))
    pose_loss = pose.mean(dim=1)
    shape_loss = (shape_r ** 2).mean(dim=1) + (shape_l ** 2).mean(dim=1)
    return pose_loss + shape_loss * 0.1


def photometric_loss(rendered: torch.Tensor, image: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 photometric term per sample (B,): rendered/image
    (B, H, W, 3), mask (B, H, W)."""
    diff = torch.abs(rendered - image) * mask[..., None]
    denom = torch.clamp(mask.sum(dim=(1, 2)), min=1.0) * 3.0
    return diff.sum(dim=(1, 2, 3)) / denom


def silhouette_loss(pred_mask: torch.Tensor,
                    gt_mask: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE of soft silhouettes (B,)."""
    B = pred_mask.shape[0]
    return ((pred_mask - gt_mask) ** 2).reshape(B, -1).mean(dim=1)


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """PSNR over the masked region, images in [0, 255]: the mean squared
    error over every element, scaled by ``img1.shape[0] * img1.shape[1] /
    masked pixel count`` (the JAX function's normalization, whatever the
    layout of the leading axes)."""
    area = torch.clamp((mask > 0).sum(), min=1)
    mse = ((img1 - img2) ** 2).mean() * img1.shape[0] * img1.shape[1] / area
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse + 1e-12))


def hard_example_mining(per_sample_loss: torch.Tensor,
                        keep_ratio: float = 0.7) -> torch.Tensor:
    """Mean over the ``max(int(B * keep_ratio), 1)`` largest per-sample
    losses (base_trainer.py:140-142), of the global batch in a distributed
    train step."""
    per_sample_loss = mesh.batch_gather(per_sample_loss)
    B = per_sample_loss.shape[0]
    k = max(int(B * keep_ratio), 1)
    return torch.topk(per_sample_loss, k).values.mean()
