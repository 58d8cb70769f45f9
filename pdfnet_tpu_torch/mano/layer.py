"""Differentiable MANO hand model in PyTorch (port of
``pdfnet_tpu/mano/layer.py``; reference ManoLayer, manolayer.py:100-334):
shape blend shapes -> pose blend shapes -> 16-joint kinematic chain ->
linear blend skinning -> fingertips -> 21-joint order.

Everything is float32, the JAX layer's ``Precision.HIGHEST`` products being
float32 products here (``torch.backends.cuda.matmul.allow_tf32`` is off by
default).  Constants live in a :class:`ManoConsts` on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pdfnet_tpu_torch import assets


class ManoConsts(NamedTuple):
    v_template: torch.Tensor       # (778, 3)
    shapedirs: torch.Tensor        # (778, 3, 10)
    posedirs: torch.Tensor         # (778, 3, 135)
    J_regressor: torch.Tensor      # (16, 778)
    weights: torch.Tensor          # (778, 16)
    hands_components: torch.Tensor  # (45, 45)
    hands_mean: torch.Tensor       # (45,)
    parent: tuple                  # 16 ints
    tip_verts: tuple               # 5 ints
    new_order: tuple               # 21 ints


def load_mano_consts(side: str, fix_shape: bool = True,
                     device="cuda") -> ManoConsts:
    """MANO constants of one hand on ``device`` (the card unless the caller
    asks for the CPU, as every entry point of the port); ``fix_shape``
    applies the left-hand shapedirs sign fix (``assets.load_mano``)."""
    m = assets.load_mano(side, fix_shape=fix_shape)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return ManoConsts(
        v_template=t(m.v_template), shapedirs=t(m.shapedirs),
        posedirs=t(m.posedirs), J_regressor=t(m.J_regressor),
        weights=t(m.weights), hands_components=t(m.hands_components),
        hands_mean=t(m.hands_mean),
        parent=tuple(int(p) for p in m.parent),
        tip_verts=tuple(int(v) for v in m.tip_verts),
        new_order=tuple(assets.NEW_ORDER))


def rodrigues(axis: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), with the
    reference's eps inside the norm (manolayer.rodrigues_batch)."""
    batch_shape = axis.shape[:-1]
    a = axis.reshape(-1, 3)
    angle = torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8
    axes = a / angle
    sin = torch.sin(angle)[..., None]
    cos = torch.cos(angle)[..., None]
    ax, ay, az = axes[:, 0], axes[:, 1], axes[:, 2]
    zeros = torch.zeros_like(ax)
    # skew-symmetric L with L @ v = axes x v
    L = torch.stack([torch.stack([zeros, -az, ay], dim=-1),
                     torch.stack([az, zeros, -ax], dim=-1),
                     torch.stack([-ay, ax, zeros], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    R = eye + sin * L + (1.0 - cos) * torch.matmul(L, L)
    return R.reshape(*batch_shape, 3, 3)


def axis_to_rmat(axis: torch.Tensor) -> torch.Tensor:
    """(B, 3k) axis-angle stack -> (B, k, 3, 3) rotation matrices."""
    return rodrigues(axis.reshape(axis.shape[0], -1, 3))


def pca_to_axis(consts: ManoConsts, pca: torch.Tensor) -> torch.Tensor:
    """PCA pose coefficients (B, n<=45) -> 45-dim axis-angle."""
    n = pca.shape[1]
    return torch.matmul(pca, consts.hands_components[:n]) + consts.hands_mean


def mano_forward(consts: ManoConsts, root_rot: torch.Tensor,
                 pose: torch.Tensor, shape: torch.Tensor,
                 trans: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 center_idx: Optional[int] = None, use_pca: bool = False):
    """MANO forward kinematics + LBS.

    root_rot (B, 3) axis-angle or (B, 3, 3); pose (B, 45) axis-angle,
    (B, n) PCA coefficients with ``use_pca``, or (B, 15, 3, 3); shape
    (B, 10); optional trans (B, 3), scale (B,), center_idx (joint to
    subtract).  Returns (verts (B, 778, 3), joints (B, 21, 3)).
    """
    B = root_rot.shape[0]
    if use_pca:
        rot_mats = rodrigues(pca_to_axis(consts, pose).reshape(B, 15, 3))
    elif pose.dim() == 4:
        rot_mats = pose
    else:
        rot_mats = rodrigues(pose.reshape(B, 15, 3))
    root_R = rodrigues(root_rot) if root_rot.dim() == 2 else root_rot

    v_shaped = consts.v_template + torch.einsum("vct,bt->bvc",
                                                consts.shapedirs, shape.float())
    j_tpose = torch.einsum("jv,bvc->bjc", consts.J_regressor, v_shaped)
    eye = torch.eye(3, dtype=torch.float32, device=v_shaped.device)
    pose_feat = (rot_mats - eye).reshape(B, 135)
    v_tpose = v_shaped + torch.einsum("vcp,bp->bvc", consts.posedirs,
                                      pose_feat)

    def se3(R, j):            # rotation about joint j: [R | (I - R) j]
        return R, torch.einsum("bij,bj->bi", eye - R, j)

    Rs, ts = [None] * 16, [None] * 16
    Rs[0], ts[0] = se3(root_R, j_tpose[:, 0])
    joints_wo_tips = [j_tpose[:, 0]]
    for i in range(1, 16):
        Ri, ti = se3(rot_mats[:, i - 1], j_tpose[:, i])
        p = consts.parent[i]
        Rs[i] = torch.einsum("bij,bjk->bik", Rs[p], Ri)
        ts[i] = torch.einsum("bij,bj->bi", Rs[p], ti) + ts[p]
        joints_wo_tips.append(
            torch.einsum("bij,bj->bi", Rs[p], j_tpose[:, i]) + ts[p])

    R_j = torch.stack(Rs, dim=1)                    # (B, 16, 3, 3)
    t_j = torch.stack(ts, dim=1)                    # (B, 16, 3)
    se3_flat = torch.cat([R_j.reshape(B, 16, 9), t_j], dim=-1)
    blended = torch.einsum("vj,bjk->bvk", consts.weights, se3_flat)
    R_v = blended[..., :9].reshape(B, 778, 3, 3)
    v_out = torch.einsum("bvij,bvj->bvi", R_v, v_tpose) + blended[..., 9:]

    tips = [v_out[:, tv] for tv in consts.tip_verts]
    j_out = torch.stack(joints_wo_tips + tips, dim=1)[:, list(consts.new_order)]
    if center_idx is not None:
        center = j_out[:, center_idx:center_idx + 1]
        v_out, j_out = v_out - center, j_out - center
    if scale is not None:
        s = scale[:, None, None]
        v_out, j_out = v_out * s, j_out * s
    if trans is not None:
        t = trans[:, None, :]
        v_out, j_out = v_out + t, j_out + t
    return v_out, j_out
