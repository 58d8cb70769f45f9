"""Eval outputs of the live H2O/interact branch (port of
``pdfnet_tpu/train/loss.py``: ``load_loss_consts`` and ``eval_outputs``,
:47-57 and :434-484).  The training loss is a later slice."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from pdfnet_tpu_torch import assets
from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.handnet import resolve_device
from pdfnet_tpu_torch.ops.geometry import perspective_project, uv_root_to_3d


class LossConsts(NamedTuple):
    regressor_left: torch.Tensor   # (21, 778)
    regressor_right: torch.Tensor
    faces_left: np.ndarray         # (1538, 3)
    faces_right: np.ndarray
    perm_left: np.ndarray          # (1008,) vert -> GCN permutation
    perm_right: np.ndarray


def load_loss_consts(device="cuda") -> LossConsts:
    """The eval constants, the regressors on ``device``: the card by
    default; raises without one."""
    device = resolve_device(device)
    gl, gr = assets.load_graph("left"), assets.load_graph("right")
    reg = lambda side: torch.as_tensor(assets.full_regressor(side),
                                       device=device)
    return LossConsts(
        regressor_left=reg("left"), regressor_right=reg("right"),
        faces_left=np.asarray(assets.load_mano("left").faces),
        faces_right=np.asarray(assets.load_mano("right").faces),
        perm_left=gl.graph_perm, perm_right=gr.graph_perm)


def _regress(reg: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    return torch.einsum("jv,bvc->bjc", reg.to(verts.device), verts)


def eval_outputs(cfg: Config, consts: LossConsts, result, params, hand_dicts,
                 other, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Test-mode outputs matching the reference eval tuple
    (simplified.py:652-653): absolute and root-relative verts/joints and the
    projected 2D landmarks, stacked [left, right] on axis 1."""
    res_px = cfg.default_resolution
    ind_lr = other["ind"]
    K_new = batch["K_new"]

    vl_off, vr_off = result["verts3d"]["left"], result["verts3d"]["right"]
    jl_off = _regress(consts.regressor_left, vl_off)
    jr_off = _regress(consts.regressor_right, vr_off)

    def root(side, col):
        p = params["root"][side]
        return uv_root_to_3d(ind_lr[:, col], p[:, 1:] / 100.0,
                             0.4 + p[:, 0] / 100.0, K_new, res_px,
                             cfg.down_ratio)

    root_l, root_r = root("left", 0), root("right", 1)
    jl_abs, jr_abs = jl_off + root_l, jr_off + root_r
    out = {
        "verts_pred": torch.stack([vl_off + root_l, vr_off + root_r], dim=1),
        "joints_pred": torch.stack([jl_abs, jr_abs], dim=1),
        "verts_pred_off": torch.stack([vl_off, vr_off], dim=1),
        "joints_pred_off": torch.stack([jl_off, jr_off], dim=1),
        "lms21_pred": torch.stack([perspective_project(jl_abs, K_new),
                                   perspective_project(jr_abs, K_new)], dim=1),
    }
    if "verts_left_gt" in batch:
        vl_gt, vr_gt = batch["verts_left_gt"], batch["verts_right_gt"]
        vl_gt_off = vl_gt - batch["joints_left_gt"][:, 9:10]
        vr_gt_off = vr_gt - batch["joints_right_gt"][:, 9:10]
        out.update(
            verts_gt=torch.stack([vl_gt, vr_gt], dim=1),
            joints_gt=torch.stack([batch["joints_left_gt"],
                                   batch["joints_right_gt"]], dim=1),
            verts_gt_off=torch.stack([vl_gt_off, vr_gt_off], dim=1),
            joints_gt_off=torch.stack(
                [_regress(consts.regressor_left, vl_gt_off),
                 _regress(consts.regressor_right, vr_gt_off)], dim=1),
        )
    return out
