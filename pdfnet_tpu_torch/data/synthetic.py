"""Synthetic RGB-D two-hand batches (port of ``pdfnet_tpu/data/synthetic.py``:
``make_sample``, ``make_batch``, ``SyntheticHandDataset``).

Random MANO parameters give the ground-truth meshes and joints (the port's
MANO on the CPU); depth comes from splatting the vertices through the
camera, masks from the splats, CenterNet targets from the projected
landmarks, and point clouds from the dataset's sampler.  Every key matches
the H2O dataset dict, so a real dataset drops in.  Host-side numpy: the
train step moves the batch to the card.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data.cloud import fps_reorder_cloud, sample_hand_cloud
from pdfnet_tpu_torch.data.targets import centernet_targets
from pdfnet_tpu_torch.mano import layer as mano

_CONSTS: Dict[str, mano.ManoConsts] = {}


def _consts(side: str) -> mano.ManoConsts:
    if side not in _CONSTS:
        # ground truth is built with numpy on the host
        _CONSTS[side] = mano.load_mano_consts(side, device="cpu")
    return _CONSTS[side]


def _splat_depth_mask(verts2d: np.ndarray, z: np.ndarray, res: int,
                      block: int = 8):
    """Coarse splat of projected vertices -> (depth, mask) at full res."""
    g = res // block
    depth_g = np.full((g, g), np.inf, np.float32)
    lo = np.floor(verts2d / block).astype(np.int64)
    ok = (lo[:, 0] >= 0) & (lo[:, 0] < g) & (lo[:, 1] >= 0) & (lo[:, 1] < g)
    np.minimum.at(depth_g, (lo[ok, 1], lo[ok, 0]), z[ok])
    mask_g = np.isfinite(depth_g)
    depth_g[~mask_g] = 0.0
    depth = np.kron(depth_g, np.ones((block, block), np.float32))
    mask = np.kron(mask_g.astype(np.float32), np.ones((block, block),
                                                      np.float32))
    return depth, mask


def make_sample(cfg: Config, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    res = cfg.default_resolution
    f = res * 1.25
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1]], np.float32)

    verts, joints, verts2d, lms = {}, {}, {}, {}
    for side, x_off in (("left", -0.09), ("right", 0.05)):
        root = rng.uniform(-0.6, 0.6, (1, 3)).astype(np.float32)
        pose = rng.uniform(-0.4, 0.4, (1, 45)).astype(np.float32)
        shape = rng.uniform(-1.5, 1.5, (1, 10)).astype(np.float32)
        trans = np.array([[x_off + rng.uniform(-0.02, 0.02),
                           rng.uniform(-0.04, 0.04),
                           0.55 + rng.uniform(-0.05, 0.05)]], np.float32)
        with torch.no_grad():
            v, j = mano.mano_forward(_consts(side), torch.from_numpy(root),
                                     torch.from_numpy(pose),
                                     torch.from_numpy(shape),
                                     trans=torch.from_numpy(trans))
        v, j = v[0].numpy(), j[0].numpy()
        verts[side], joints[side] = v, j
        p = v @ K.T
        verts2d[side] = (p[:, :2] / p[:, 2:]).astype(np.float32)
        pj = j @ K.T
        lms[side] = (pj[:, :2] / pj[:, 2:]).astype(np.float32)

    d_l, m_l = _splat_depth_mask(verts2d["left"], verts["left"][:, 2], res)
    d_r, m_r = _splat_depth_mask(verts2d["right"], verts["right"][:, 2], res)
    depth = np.where((d_l > 0) & ((d_r == 0) | (d_l < d_r)), d_l, d_r)
    mask = np.stack([m_r, m_l], axis=-1)            # channels [right, left]

    # cheap synthetic RGB: normalized inverse depth + noise
    img = np.zeros((res, res, 3), np.float32)
    vis = depth > 0
    img[..., 0] = np.where(vis, 1.0 - (depth - 0.4) * 2.0, 0.1)
    img[..., 1] = np.where(vis, 0.6, 0.2)
    img[..., 2] = np.where(vis, 0.4, 0.3)
    img += rng.uniform(-0.05, 0.05, img.shape).astype(np.float32)
    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)
    img = (np.clip(img, 0, 1) - mean) / std

    tgt = centernet_targets(lms["left"], lms["right"], 1, 1, res,
                            cfg.down_ratio)

    n = cfg.sample_num
    normals = cfg.input_feature_num == 6
    choose_l, cloud_l, ok_l = sample_hand_cloud(depth * m_l, K, n, rng,
                                                with_normals=normals)
    choose_r, cloud_r, ok_r = sample_hand_cloud(depth * m_r, K, n, rng,
                                                with_normals=normals)
    if cfg.sample_strategy == "FPS":
        if ok_l:
            cloud_l, choose_l = fps_reorder_cloud(
                cloud_l, choose_l, cfg.sample_num_level1,
                cfg.sample_num_level2, rng)
        if ok_r:
            cloud_r, choose_r = fps_reorder_cloud(
                cloud_r, choose_r, cfg.sample_num_level1,
                cfg.sample_num_level2, rng)
    valid = np.array([float(ok_l), float(ok_r)], np.float32) * tgt["valid"]

    return {
        "input": img.astype(np.float32),
        "depth": depth.astype(np.float32),
        "cloud": np.stack([cloud_l, cloud_r]).astype(np.float32),
        "choose": np.stack([choose_l, choose_r]),
        "hm": tgt["hm"], "hms": tgt["hms"], "wh": tgt["wh"],
        "off_hm": tgt["off_hm"], "off_lms": tgt["off_lms"],
        "ind": tgt["ind"], "valid": valid,
        "mask": mask.astype(np.float32),
        "mask_left_gt": m_l.astype(np.float32),
        "mask_right_gt": m_r.astype(np.float32),
        "lms": np.concatenate([lms["left"], lms["right"]]).astype(np.float32),
        "K_new": K,
        "lms_left_gt": lms["left"], "lms_right_gt": lms["right"],
        "joints_left_gt": joints["left"].astype(np.float32),
        "joints_right_gt": joints["right"].astype(np.float32),
        "verts_left_gt": verts["left"].astype(np.float32),
        "verts_right_gt": verts["right"].astype(np.float32),
        "verts2d_left_gt": verts2d["left"],
        "verts2d_right_gt": verts2d["right"],
    }


def make_batch(cfg: Config, batch_size: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    samples = [make_sample(cfg, seed * 10007 + i) for i in range(batch_size)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class SyntheticHandDataset:
    """Dataset of synthetic RGB-D samples (H2O-dict-compatible), the
    ``--synthetic`` data of the CLI (port of JAX's ``SyntheticHandDataset``;
    its clouds come from the numpy sampler, as ``make_sample`` takes them)."""

    def __init__(self, cfg: Config, size: int = 512, seed: int = 0,
                 train: bool = True):
        self.cfg = cfg
        self.size = size
        self.seed = seed
        self.train = train

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return make_sample(self.cfg, self.seed * 1000003 + idx)

    def batches(self, batch_size: int, epoch: int = 0,
                process_index: int = 0, process_count: int = 1):
        from pdfnet_tpu_torch.data.loader import iter_batches
        return iter_batches(
            self.__getitem__, self.size, batch_size, shuffle=self.train,
            seed=self.seed + epoch, pad_tail=not self.train,
            process_index=process_index, process_count=process_count)
