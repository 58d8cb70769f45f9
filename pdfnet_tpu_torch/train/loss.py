"""Training loss and eval outputs of the live H2O/interact branch (port of
``pdfnet_tpu/train/loss.py``: ``load_loss_consts``, ``compute_loss`` and its
terms, ``eval_outputs``; reference lib/trains/simplified.py:364-655).

Layouts are the JAX package's: heatmaps (B, H/4, W/4, C) and masks
(B, H, W, 2) channel-last, batch keys as in the reference dataset dict.  The
JAX products at ``Precision.HIGHEST`` are float32 products here, which stay
float32 on the card because ``torch.backends.cuda.matmul.allow_tf32`` is off
by default.  Index arrays (faces, graph permutations, bones) live on the
consts' device, so the loss reads nothing from the host.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from pdfnet_tpu_torch import assets
from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.handnet import resolve_device
from pdfnet_tpu_torch.ops.gather import gather_pixels
from pdfnet_tpu_torch.ops.geometry import perspective_project, uv_root_to_3d
from pdfnet_tpu_torch.ops.heatmap import clamped_sigmoid

# 20 hand bones as (parent, child) joint-index pairs (losses.py:37-56).
BONES = np.array(
    [(0, 1), (1, 2), (2, 3), (3, 4),
     (0, 5), (5, 6), (6, 7), (7, 8),
     (0, 9), (9, 10), (10, 11), (11, 12),
     (0, 13), (13, 14), (14, 15), (15, 16),
     (0, 17), (17, 18), (18, 19), (19, 20)], np.int64)


class LossConsts(NamedTuple):
    regressor_left: torch.Tensor   # (21, 778)
    regressor_right: torch.Tensor
    faces_left: torch.Tensor       # (1538, 3) int64
    faces_right: torch.Tensor
    perm_left: torch.Tensor        # (1008,) int64 vert -> GCN permutation
    perm_right: torch.Tensor
    bones: torch.Tensor            # (20, 2) int64 (BONES)


def load_loss_consts(device="cuda") -> LossConsts:
    """The loss and eval constants on ``device``: the card by default;
    raises without one."""
    device = resolve_device(device)
    gl, gr = assets.load_graph("left"), assets.load_graph("right")
    reg = lambda side: torch.as_tensor(assets.full_regressor(side),
                                       device=device)
    index = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return LossConsts(
        regressor_left=reg("left"), regressor_right=reg("right"),
        faces_left=index(assets.load_mano("left").faces),
        faces_right=index(assets.load_mano("right").faces),
        perm_left=index(gl.graph_perm), perm_right=index(gr.graph_perm),
        bones=index(BONES))


def _regress(reg: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    return torch.einsum("jv,bvc->bjc", reg.to(verts.device), verts)


# ---- loss terms (pdfnet_tpu/train/loss.py:60-171) ---------------------------

def focal_loss(pred: torch.Tensor, gt: torch.Tensor,
               batch_global_guard: bool = False) -> torch.Tensor:
    """CornerNet focal loss per sample (B,); pred post-sigmoid.

    A sample without positives returns its raw negative term (per-sample
    guard, the default); ``batch_global_guard`` is the reference's rule,
    which falls back only when the whole batch has no positive."""
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_w = (1.0 - gt) ** 4
    pos_l = torch.log(pred) * (1.0 - pred) ** 2 * pos
    neg_l = torch.log(1.0 - pred) * pred ** 2 * neg_w * neg
    dims = tuple(range(1, pred.dim()))
    num_pos = pos.sum(dims)
    pos_s, neg_s = pos_l.sum(dims), neg_l.sum(dims)
    if batch_global_guard:
        return torch.where(num_pos.sum() == 0, -neg_s,
                           -(pos_s + neg_s) / (num_pos + 1e-3))
    denom = torch.clamp(num_pos, min=1.0)
    return torch.where(num_pos == 0, -neg_s, -(pos_s + neg_s) / denom)


def smooth_l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    d = torch.abs(pred - gt)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


def l1_per_sample(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).reshape(pred.shape[0], -1).mean(dim=1)


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def mse_per_sample(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).reshape(pred.shape[0], -1).mean(dim=1)


def reg_l1_loss(output_map: torch.Tensor, mask: torch.Tensor,
                ind: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Masked L1 on features gathered at the center indices, normalized by
    the masked element count (RegL1Loss).  output_map (B, H, W, C) or values
    already at the centers (B, K, C); mask, ind (B, K); target (B, K, C)."""
    pred = output_map if output_map.dim() == 3 else gather_pixels(output_map,
                                                                  ind)
    m = mask[..., None].expand(pred.shape).to(pred.dtype)
    return torch.abs(pred * m - target * m).sum() / (m.sum() + 1e-8)


def _unit(e: torch.Tensor) -> torch.Tensor:
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-12)


def face_normal_loss(pred, gt, faces: torch.Tensor) -> torch.Tensor:
    """Predicted edge directions must be orthogonal to the GT face normals."""
    f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]

    def edges(v):
        return (_unit(v[:, f1] - v[:, f0]), _unit(v[:, f2] - v[:, f0]),
                _unit(v[:, f2] - v[:, f1]))

    p1, p2, p3 = edges(pred)
    g1, g2, _ = edges(gt)
    n_gt = _unit(torch.linalg.cross(g1, g2, dim=-1))
    cos = [torch.abs(torch.sum(p * n_gt, dim=-1)) for p in (p1, p2, p3)]
    return torch.mean(torch.stack(cos))


def edge_length_loss(pred, gt, faces: torch.Tensor) -> torch.Tensor:
    f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]
    norm = lambda e: torch.linalg.vector_norm(e, dim=-1)

    def lengths(v):
        return (norm(v[:, f0] - v[:, f1]), norm(v[:, f0] - v[:, f2]),
                norm(v[:, f1] - v[:, f2]))

    diffs = [torch.abs(p - g) for p, g in zip(lengths(pred), lengths(gt))]
    return torch.mean(torch.stack(diffs))


def bone_direction_loss(j2d: torch.Tensor, j2d_gt: torch.Tensor,
                        bones: torch.Tensor) -> torch.Tensor:
    """Cosine mismatch of 2D bone directions, per sample (B,)."""
    def bone_vecs(j):
        v = j[:, bones[:, 1]] - j[:, bones[:, 0]]              # (B, 20, 2)
        return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-4)

    d = bone_vecs(j2d) - bone_vecs(j2d_gt)
    return torch.sum(d * d, dim=-1).mean(dim=1)


def mesh_downsample_pyramid(v1008: torch.Tensor,
                            target_verts: int) -> torch.Tensor:
    """Average-pool the padded 1008-vertex tensor down to ``target_verts``."""
    v = v1008
    while v.shape[1] > target_verts:
        B, V, F_ = v.shape
        v = v.reshape(B, V // 2, 2, F_).mean(dim=2)
    return v


# ---- the loss (pdfnet_tpu/train/loss.py:228-431) ----------------------------

def compute_loss(cfg: Config, consts: LossConsts, result: Dict[str, Any],
                 params: Dict[str, Any], hand_dicts, other: Dict[str, Any],
                 batch: Dict[str, torch.Tensor], epoch: int,
                 mode: str = "train"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (scalar loss, stats), every term and gate of the JAX
    ``compute_loss``: the 14 weighted terms, the ``epoch >=
    edge_loss_start_epoch`` gate on the edge and 2-D joint terms, the
    ``replicate_reference_quirks`` and ``off`` variants, and joints-only
    batches (no vertex ground truth: the mesh terms are zero)."""
    if cfg.photometric_loss:
        raise NotImplementedError("photometric_loss needs the renderer, "
                                  "which the rendering slice of the port "
                                  "brings")
    res_px = cfg.default_resolution
    valid = batch["valid"]                                  # (B, 2)
    dev = valid.device
    zero = torch.zeros((), device=dev)
    stats: Dict[str, torch.Tensor] = {}

    is_train = mode == "train"
    ind_lr = batch["ind"] if is_train else other["ind"]     # (B, 2)

    # --- detection / segmentation terms -----------------------------------
    mask_loss = smooth_l1(other["mask"], batch["mask"])
    hms_loss = mse(other["hms"], batch["hms"])
    center_hm = clamped_sigmoid(other["ret"]["hm"])
    hm_loss = focal_loss(center_hm, batch["hm"],
                         batch_global_guard=cfg.replicate_reference_quirks)
    wh_loss = (reg_l1_loss(other["ret"]["wh"], valid, batch["ind"],
                           batch["wh"])
               if (cfg.use_wh_loss or cfg.off) and "wh" in batch else zero)
    if cfg.off and "off_hm" in batch:
        off_hm_loss = reg_l1_loss(other["ret"]["off_hm"], valid,
                                  batch["ind"], batch["off_hm"])
        off_lms_loss = reg_l1_loss(other["ret"]["off_lms"], valid,
                                   batch["ind"], batch["off_lms"])
    else:
        off_hm_loss = off_lms_loss = zero

    # --- mesh ground truth (vertex GT for H2O; joints only otherwise) -----
    has_verts = "verts_left_gt" in batch
    jl_gt_abs, jr_gt_abs = batch["joints_left_gt"], batch["joints_right_gt"]
    root_l_gt, root_r_gt = jl_gt_abs[:, 9:10], jr_gt_abs[:, 9:10]
    if has_verts:
        vl_gt, vr_gt = batch["verts_left_gt"], batch["verts_right_gt"]
        vl_gt_off, vr_gt_off = vl_gt - root_l_gt, vr_gt - root_r_gt
        jl_gt_off = _regress(consts.regressor_left, vl_gt_off)
        jr_gt_off = _regress(consts.regressor_right, vr_gt_off)
    else:
        jl_gt_off, jr_gt_off = jl_gt_abs - root_l_gt, jr_gt_abs - root_r_gt

    vl_off, vr_off = result["verts3d"]["left"], result["verts3d"]["right"]
    jl_off = _regress(consts.regressor_left, vl_off)
    jr_off = _regress(consts.regressor_right, vr_off)

    # --- root-relative vertex / joint terms -------------------------------
    norm01 = lambda x: x / res_px * 2.0 - 1.0
    joints_loss = (l1_per_sample(jl_off, jl_gt_off) * valid[:, 0] +
                   l1_per_sample(jr_off, jr_gt_off) * valid[:, 1])
    if has_verts:
        verts2d_loss = (mse(norm01(result["verts2d"]["left"]),
                            norm01(batch["verts2d_left_gt"])) +
                        mse(norm01(result["verts2d"]["right"]),
                            norm01(batch["verts2d_right_gt"])))
        verts_loss = (l1_per_sample(vl_off, vl_gt_off) * valid[:, 0] +
                      l1_per_sample(vr_off, vr_gt_off) * valid[:, 1])
        norm_loss = (face_normal_loss(vl_off, vl_gt_off, consts.faces_left) +
                     face_normal_loss(vr_off, vr_gt_off, consts.faces_right))
        edge_loss = (edge_length_loss(vl_off, vl_gt_off, consts.faces_left) +
                     edge_length_loss(vr_off, vr_gt_off, consts.faces_right))
    else:
        verts2d_loss = verts_loss = norm_loss = edge_loss = zero

    # --- coarse (252-vertex) GCN supervision ------------------------------
    v252_l = hand_dicts[0]["verts3d"]["left"]
    v252_r = hand_dicts[0]["verts3d"]["right"]
    v252_2d_l = hand_dicts[0]["verts2d"]["left"]
    v252_2d_r = hand_dicts[0]["verts2d"]["right"]
    if has_verts:
        # reference quirks (simplified.py:463, :481-482): the right hand's
        # GCN target reuses the left GT, and both terms take the left gate
        quirks = cfg.replicate_reference_quirks
        vr_gt_for_gcn = vl_gt_off if quirks else vr_gt_off
        gt252_l = mesh_downsample_pyramid(vl_gt_off[:, consts.perm_left], 252)
        gt252_r = mesh_downsample_pyramid(vr_gt_for_gcn[:, consts.perm_right],
                                          252)
        gt252_2d_l = mesh_downsample_pyramid(
            batch["verts2d_left_gt"][:, consts.perm_left], 252)
        gt252_2d_r = mesh_downsample_pyramid(
            batch["verts2d_right_gt"][:, consts.perm_right], 252)
        v_r_gate = valid[:, 0] if quirks else valid[:, 1]
        gcn_loss = (l1_per_sample(v252_l, gt252_l) * valid[:, 0] +
                    l1_per_sample(v252_r, gt252_r) * v_r_gate)
        gcn_2d_loss = (mse(norm01(v252_2d_l), norm01(gt252_2d_l)) +
                       mse(norm01(v252_2d_r), norm01(gt252_2d_r)))
    else:
        gcn_loss = gcn_2d_loss = zero

    # --- absolute root / absolute pose ------------------------------------
    root_z_l = 0.4 + params["root"]["left"][:, 0] / 100.0
    root_z_r = 0.4 + params["root"]["right"][:, 0] / 100.0
    root_xy_l = params["root"]["left"][:, 1:] / 100.0
    root_xy_r = params["root"]["right"][:, 1:] / 100.0
    K_new = batch["K_new"]
    root_l_pred = uv_root_to_3d(ind_lr[:, 0], root_xy_l, root_z_l, K_new,
                                res_px, cfg.down_ratio)
    root_r_pred = uv_root_to_3d(ind_lr[:, 1], root_xy_r, root_z_r, K_new,
                                res_px, cfg.down_ratio)

    jl_abs = jl_off + (root_l_gt if is_train else root_l_pred)
    jr_abs = jr_off + (root_r_gt if is_train else root_r_pred)
    vl_abs, vr_abs = vl_off + root_l_pred, vr_off + root_r_pred

    lms_l_proj = perspective_project(jl_abs, K_new)
    lms_r_proj = perspective_project(jr_abs, K_new)
    joints2d_loss = (mse_per_sample(norm01(lms_l_proj),
                                    norm01(batch["lms_left_gt"])) * valid[:, 0] +
                     mse_per_sample(norm01(lms_r_proj),
                                    norm01(batch["lms_right_gt"])) * valid[:, 1])

    root_loss = (l1_per_sample(root_l_pred, root_l_gt) * valid[:, 0] * 1000.0 +
                 l1_per_sample(root_r_pred, root_r_gt) * valid[:, 1] * 1000.0)
    abs_joints_loss = (l1_per_sample(jl_abs, jl_gt_abs) * valid[:, 0] +
                       l1_per_sample(jr_abs, jr_gt_abs) * valid[:, 1]) * 1000.0
    if has_verts:
        abs_verts_loss = (l1_per_sample(vl_abs, vl_gt) * valid[:, 0] +
                          l1_per_sample(vr_abs, vr_gt) * valid[:, 1]) * 1000.0
    else:
        abs_verts_loss = zero

    bone_loss = (bone_direction_loss(lms_l_proj, batch["lms_left_gt"],
                                     consts.bones) * valid[:, 0] +
                 bone_direction_loss(lms_r_proj, batch["lms_right_gt"],
                                     consts.bones) * valid[:, 1])

    # --- weighted sum (simplified.py:608-650) ------------------------------
    alpha = float(epoch >= cfg.edge_loss_start_epoch)
    w = cfg.reproj_weight
    loss = cfg.center_weight * hm_loss
    if cfg.use_wh_loss:
        loss = loss + cfg.wh_weight * wh_loss * 0.1
    if cfg.off:
        # off branch weighting (simplified.py:998-1004)
        loss = loss + cfg.off_weight * (off_hm_loss + off_lms_loss)
        if not cfg.use_wh_loss:
            loss = loss + cfg.wh_weight * wh_loss
    loss = loss + w * root_loss
    if cfg.reproj_loss:
        loss = loss + w * verts_loss * 500.0
        loss = loss + w * abs_verts_loss * 0.1
        loss = loss + w * verts2d_loss * 50.0
        loss = loss + w * norm_loss * 10.0
        loss = loss + w * edge_loss * 2000.0 * alpha
        loss = loss + w * gcn_loss * 100.0
        loss = loss + w * gcn_2d_loss * 50.0
        loss = loss + w * mask_loss * 2000.0
        loss = loss + w * abs_joints_loss * 0.1
        loss = loss + w * hms_loss * 2000.0
        loss = loss + w * joints2d_loss * 1000.0 * alpha
        loss = loss + w * joints_loss * 500.0
        if cfg.bone_loss:
            loss = loss + cfg.bone_dir_weight * bone_loss
    total = loss.mean()
    if cfg.off:
        stats.update(off_hm_loss=off_hm_loss, off_lms_loss=off_lms_loss)
    stats.update(
        loss=total, hm_loss=hm_loss.mean(), wh_loss=wh_loss,
        root_loss=root_loss.mean(),
        verts_loss=verts_loss.mean(), abs_verts_loss=abs_verts_loss.mean(),
        verts2d_loss=verts2d_loss, norm_loss=norm_loss, edge_loss=edge_loss,
        gcn_loss=gcn_loss.mean(), gcn_2d_loss=gcn_2d_loss,
        mask_loss=mask_loss, abs_joints_loss=abs_joints_loss.mean(),
        hms_loss=hms_loss, joints2d_loss=joints2d_loss.mean(),
        joints_loss=joints_loss.mean(), bone_direc_loss=bone_loss.mean())
    return total, stats


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
