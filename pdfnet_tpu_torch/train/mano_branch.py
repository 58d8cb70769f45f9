"""The MANO-parameter regression branch and the CSP detector's loss (port
of ``pdfnet_tpu/train/mano_branch.py``; reference Split_coeff,
Mano_render.py:145-194, and origforward, simplified.py:657-1048).

The ``params`` head regresses 122 MANO parameters per pixel; decoded at the
hand-center cells into per-hand (orient, pose, shape, trans) they go
through the differentiable MANO layer, and the losses are 2-D reprojection,
bone direction and the pose/shape prior.  ``csp_loss`` is the CSP
detector's train loss; with ``Config.replicate_reference_quirks`` it is the
reference's origforward composition term for term (``origforward_loss``).
Terms that the reference multiplies by 0 are multiplied by 0 here too, so
their gradient path stays (and a non-finite term still poisons the sum).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.mano.layer import ManoConsts, load_mano_consts, mano_forward
from pdfnet_tpu_torch.models.handnet import resolve_device
from pdfnet_tpu_torch.ops.gather import gather_pixels
from pdfnet_tpu_torch.ops.geometry import perspective_project
from pdfnet_tpu_torch.ops.heatmap import clamped_sigmoid
from pdfnet_tpu_torch.train.loss import (BONES, bone_direction_loss,
                                         focal_loss, l1_per_sample,
                                         mse_per_sample, reg_l1_loss)
from pdfnet_tpu_torch.train.priors import pose_shape_prior_loss

Tensors = Dict[str, torch.Tensor]


class ManoBranchConsts(NamedTuple):
    left: ManoConsts
    right: ManoConsts
    bones: torch.Tensor            # (20, 2) int64, the bone-direction pairs


def load_mano_branch_consts(device="cuda") -> ManoBranchConsts:
    """Both hands' MANO constants and the bone pairs on ``device``: the
    card by default; raises without one."""
    device = resolve_device(device)
    return ManoBranchConsts(
        left=load_mano_consts("left", device=device),
        right=load_mano_consts("right", device=device),
        bones=torch.as_tensor(BONES, device=device))


def split_coeff(theta: torch.Tensor, ind: torch.Tensor, K: torch.Tensor,
                input_res: int = 384, down_ratio: int = 4,
                num_pca: int = 0) -> Dict[str, Tensors]:
    """Decode a (B, 122) parameter vector into per-hand MANO inputs.

    Layout per hand (61): orient 3, pose 45 (or ``num_pca`` PCA
    coefficients), shape 10, trans 3; without PCA the shape is zeroed.  The
    translation's xy is an offset from the hand-center cell, lifted through
    the intrinsics with z biased by +0.6 m.
    """
    out = {}
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cw, ch = K[:, 0, 2], K[:, 1, 2]
    grid = input_res // down_ratio
    for h, side in enumerate(("left", "right")):
        o = 61 * h
        if num_pca:
            orient = theta[:, o:o + 3]
            pose = theta[:, o + 3:o + 3 + num_pca]
            shape = theta[:, o + 3 + num_pca:o + 13 + num_pca]
            trans = theta[:, o + 13 + num_pca:o + 16 + num_pca] / 10.0
        else:
            orient = theta[:, o:o + 3]
            pose = theta[:, o + 3:o + 48]
            shape = theta[:, o + 48:o + 58] * 0.0   # shape fixed to zero
            trans = theta[:, o + 58:o + 61]
        tz = trans[:, 2] + 0.6
        idx = ind[:, h].long()
        cx = ((idx % grid) * down_ratio).float()
        cy = ((idx // grid) * down_ratio).float()
        tx = tz * (trans[:, 0] + cx - cw) / fx
        ty = tz * (trans[:, 1] + cy - ch) / fy
        out[side] = {"orient": orient, "pose": pose, "shape": shape,
                     "trans": torch.stack([tx, ty, tz], dim=1)}
    return out


def mano_branch_forward(consts: ManoBranchConsts, coeffs,
                        use_pca: bool = False, apply_trans: bool = True):
    """Per-hand MANO forward from decoded coefficients: {'left'/'right':
    (verts (B, 778, 3), joints (B, 21, 3))} in camera space.
    ``apply_trans=False`` is the reference origforward, which decodes the
    translation and then drops it (simplified.py:735-736)."""
    out = {}
    for side, c in (("left", consts.left), ("right", consts.right)):
        p = coeffs[side]
        out[side] = mano_forward(c, p["orient"], p["pose"], p["shape"],
                                 trans=p["trans"] if apply_trans else None,
                                 use_pca=use_pca)
    return out


def _thetas_at_centers(params_map: torch.Tensor, ind: torch.Tensor):
    """The (B, 122) thetas at the left and right centers of a (B, H, W,
    122) map, or of patch-head values already at the centers (B, 2, 122)."""
    if params_map.dim() == 3:
        return params_map[:, 0], params_map[:, 1]
    return (gather_pixels(params_map, ind[:, :1])[:, 0],
            gather_pixels(params_map, ind[:, 1:])[:, 0])


def mano_branch_loss(cfg: Config, consts: ManoBranchConsts,
                     params_map: torch.Tensor, ind: torch.Tensor,
                     batch: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """Reprojection + bone + prior losses for the regression branch;
    params_map (B, H/4, W/4, 122) or (B, 2, 122), ind (B, 2)."""
    theta_l, theta_r = _thetas_at_centers(params_map, ind)
    K = batch["K_new"]
    valid = batch["valid"]
    res = cfg.default_resolution

    coeffs = {"left": split_coeff(theta_l, ind, K, res, cfg.down_ratio)["left"],
              "right": split_coeff(theta_r, ind, K, res,
                                   cfg.down_ratio)["right"]}
    hands = mano_branch_forward(consts, coeffs)

    norm01 = lambda x: x / res * 2.0 - 1.0
    losses = {}
    total = 0.0
    for h, side in enumerate(("left", "right")):
        v, j = hands[side]
        lms = perspective_project(j, K)
        gt = batch[f"lms_{side}_gt"]
        reproj = mse_per_sample(norm01(lms), norm01(gt)) * valid[:, h]
        bone = bone_direction_loss(lms, gt, consts.bones) * valid[:, h]
        losses[f"reproj_{side}"] = reproj.mean()
        losses[f"bone_{side}"] = bone.mean()
        total = total + cfg.reproj_weight * reproj * 1000.0 \
            + cfg.bone_dir_weight * bone
        if f"joints_{side}_gt" in batch:
            j3d = l1_per_sample(j, batch[f"joints_{side}_gt"]) * valid[:, h]
            losses[f"joints3d_{side}"] = j3d.mean()
            total = total + cfg.joints_weight * j3d * 100.0

    prior = pose_shape_prior_loss(coeffs["left"]["pose"],
                                  coeffs["right"]["pose"],
                                  coeffs["left"]["shape"],
                                  coeffs["right"]["shape"], cfg.dataset)
    losses["prior"] = prior.mean()
    total = total + prior
    losses["mano_branch_loss"] = total.mean()
    return total.mean(), losses


# Per-joint landmark weighting of the origforward reprojection loss
# (ManoRender.weighted_lms, Mano_render.py:68-73): wrist + the 5 fingertips
# (new_order joints 0, 4, 8, 12, 16, 20) weigh 20x; identical for u and v.
WEIGHTED_LMS = (20.0, 1.0, 1.0, 1.0, 20.0, 1.0, 1.0, 1.0, 20.0, 1.0, 1.0,
                1.0, 20.0, 1.0, 1.0, 1.0, 20.0, 1.0, 1.0, 1.0, 20.0)


def _weighted_lms_reproj(lms: torch.Tensor, gt: torch.Tensor,
                         valid_h: torch.Tensor) -> torch.Tensor:
    """The origforward landmark MSE (simplified.py:793-797): per-joint
    weighted squared error summed over uv, normalized by the (masked)
    weight sum.  lms/gt (B, 21, 2), valid_h (B,) -> (B, 21)."""
    w = torch.tensor(WEIGHTED_LMS, dtype=torch.float32,
                     device=lms.device)[None, :, None]          # (1, 21, 1)
    m = valid_h[:, None, None].float()
    se = ((lms * m - gt * m) ** 2) * w * m                      # (B, 21, 2)
    den = (w * m * torch.ones_like(se)).sum(dim=2) + 1e-8       # (B, 21)
    return se.sum(dim=2) / den


def origforward_loss(cfg: Config, consts: ManoBranchConsts,
                     theta_l: torch.Tensor, theta_r: torch.Tensor,
                     hm: torch.Tensor, batch: Tensors, epoch: int
                     ) -> Tuple[torch.Tensor, Tensors]:
    """The reference origforward train loss, term for term
    (simplified.py:657-1048; composition :989-1037):

      alpha = [epoch >= 20]
      loss  = center_weight * hm_loss * 0              (zeroed, :992)
            + reproj_weight * reproj_loss_all          (:1011)
            + norm_weight * norm_loss                  (:1013)
            + bone_dir_weight * bone_direc_loss        (:1016)
            + reproj_weight * root_loss * 0            (:1027)
            + reproj_weight * abs_joints_loss * 0      (:1029)
            + joints_weight * joints_loss * 10         (:1031)
            + [H2O] joints_weight * verts_loss         (:1034)
            + [H2O] reproj_weight * abs_verts_loss * 0.01 * alpha  (:1036)

    MANO runs without the decoded translation and with zeroed betas, so
    every 3-D term acts on untranslated zero-shape hands.  theta_* (B, 122)
    at each hand's center, hm (B, H/4, W/4, 2) logits.  Returns (per-sample
    loss (B,), stats).
    """
    K, valid, ind = batch["K_new"], batch["valid"], batch["ind"]
    res = cfg.default_resolution
    losses: Tensors = {}

    hm_loss = focal_loss(clamped_sigmoid(hm), batch["hm"],
                         batch_global_guard=True).mean()
    losses["hm_loss"] = hm_loss
    loss = cfg.center_weight * hm_loss * 0.0

    cl = split_coeff(theta_l, ind, K, res, cfg.down_ratio)["left"]
    cr = split_coeff(theta_r, ind, K, res, cfg.down_ratio)["right"]
    hands = mano_branch_forward(consts, {"left": cl, "right": cr},
                                apply_trans=False)
    vl, jl = hands["left"]
    vr, jr = hands["right"]

    norm = pose_shape_prior_loss(cl["pose"], cr["pose"], cl["shape"],
                                 cr["shape"], cfg.dataset)          # (B,)
    losses["norm_loss"] = norm.mean()

    jl_gt, jr_gt = batch["joints_left_gt"], batch["joints_right_gt"]
    root_l_gt, root_r_gt = jl_gt[:, 9:10], jr_gt[:, 9:10]
    jl_gt_off, jr_gt_off = jl_gt - root_l_gt, jr_gt - root_r_gt
    root_l, root_r = jl[:, 9:10], jr[:, 9:10]
    jl_off, jr_off = jl - root_l, jr - root_r
    vl_off, vr_off = vl - root_l, vr - root_r

    # RHD projects root-aligned joints (simplified.py:774-776); that
    # reassignment also feeds abs_joints_loss downstream (:817)
    if cfg.dataset == "RHD":
        jl_p, jr_p = jl_off + root_l_gt, jr_off + root_r_gt
    else:
        jl_p, jr_p = jl, jr
    lms_l = perspective_project(jl_p, K)
    lms_r = perspective_project(jr_p, K)
    gt_l, gt_r = batch["lms_left_gt"], batch["lms_right_gt"]

    reproj_all = (_weighted_lms_reproj(lms_l, gt_l, valid[:, 0])
                  + _weighted_lms_reproj(lms_r, gt_r, valid[:, 1])
                  ).mean(dim=1) / cfg.num_stacks                    # (B,)
    losses["reproj_loss_all"] = reproj_all.mean()
    bone = (bone_direction_loss(lms_l, gt_l, consts.bones) * valid[:, 0]
            + bone_direction_loss(lms_r, gt_r, consts.bones) * valid[:, 1])
    losses["bone_direc_loss"] = bone.mean()
    joints_loss = (l1_per_sample(jl_off, jl_gt_off) * valid[:, 0]
                   + l1_per_sample(jr_off, jr_gt_off) * valid[:, 1]) * 1000.0
    losses["joints_loss"] = joints_loss.mean()
    root_loss = (l1_per_sample(root_l, root_l_gt) * valid[:, 0] * 1000.0
                 + l1_per_sample(root_r, root_r_gt) * valid[:, 1] * 1000.0)
    losses["root_loss"] = root_loss.mean()
    abs_joints = (l1_per_sample(jl_p, jl_gt) * valid[:, 0]
                  + l1_per_sample(jr_p, jr_gt) * valid[:, 1]) * 1000.0
    losses["abs_joints_loss"] = abs_joints.mean()

    alpha = float(epoch >= 20)
    loss = (loss
            + cfg.reproj_weight * reproj_all
            + cfg.norm_weight * norm
            + cfg.bone_dir_weight * bone
            + cfg.reproj_weight * root_loss * 0.0
            + cfg.reproj_weight * abs_joints * 0.0
            + cfg.joints_weight * joints_loss * 10.0)
    if cfg.dataset == "H2O" and "verts_left_gt" in batch:
        vl_gt, vr_gt = batch["verts_left_gt"], batch["verts_right_gt"]
        verts_loss = (l1_per_sample(vl_off, vl_gt - root_l_gt) * valid[:, 0]
                      + l1_per_sample(vr_off, vr_gt - root_r_gt)
                      * valid[:, 1]) * 1000.0
        abs_verts = (l1_per_sample(vl, vl_gt) * valid[:, 0]
                     + l1_per_sample(vr, vr_gt) * valid[:, 1]) * 1000.0
        losses["verts_loss"] = verts_loss.mean()
        losses["abs_verts_loss"] = abs_verts.mean()
        loss = (loss + cfg.joints_weight * verts_loss
                + cfg.reproj_weight * abs_verts * 0.01 * alpha)
    losses["loss"] = loss.mean()
    return loss, losses


def csp_loss(cfg: Config, consts: ManoBranchConsts, ret: Dict[str, object],
             batch: Tensors, epoch: int = 0) -> Tuple[torch.Tensor, Tensors]:
    """Train loss of the CSP detector: the center focal loss + the
    MANO-theta regression terms on the last refinement iteration
    (reference origforward, simplified.py:657-760; hm/wh :695-717).  With
    ``replicate_reference_quirks`` the loss is ``origforward_loss``
    verbatim, its hm * 0 zeroing and translation-less MANO included; by
    default the center supervision stays live and the hands are translated
    before they are projected."""
    theta_map = ret["params"][-1]     # the last refinement iteration
    if cfg.replicate_reference_quirks:
        theta_l, theta_r = _thetas_at_centers(theta_map, batch["ind"])
        total, losses = origforward_loss(cfg, consts, theta_l, theta_r,
                                         ret["hm"], batch, epoch)
        return total.mean(), losses
    losses = {}
    hm_loss = focal_loss(clamped_sigmoid(ret["hm"]), batch["hm"]).mean()
    losses["hm_loss"] = hm_loss
    total_scalar = cfg.center_weight * hm_loss

    if cfg.use_wh_loss and "wh" in ret and "wh" in batch:
        wh_loss = reg_l1_loss(ret["wh"], batch["valid"], batch["ind"],
                              batch["wh"])
        losses["wh_loss"] = wh_loss
        total_scalar = total_scalar + cfg.wh_weight * wh_loss

    mano_total, mano_losses = mano_branch_loss(cfg, consts, theta_map,
                                               batch["ind"], batch)
    losses.update(mano_losses)
    total = total_scalar + mano_total
    losses["loss"] = total
    return total, losses
