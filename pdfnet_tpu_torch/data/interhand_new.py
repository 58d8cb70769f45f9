"""InterHandNew (IntagHand-format InterHand2.6M) dataset branch (port of
``pdfnet_tpu/data/interhand_new.py``; reference interhand.py:191-457).

Per-sample directory layout:
  {root}/{split}/img/{i}.jpg, mask/{i}.jpg, dense/{i}.jpg,
  hms/{i}_{0..6}_{left,right}.jpg, anno/{i}.pkl
The anno pickle carries camera {R, t, camera} and per-hand MANO parameters
{R (1, 3) axis-angle or (1, 3, 3), pose (1, 45), shape (1, 10), trans
(1, 3)}.

RGB-only branch (no depth): the point clouds are zero, (2, N, 3) whatever
``input_feature_num`` says, as the JAX dataset returns them, and hand
validity comes from the landmarks.  The ground-truth meshes come from the
port's MANO on the CPU.  No CLI path builds this dataset (nor does the JAX
CLI's).
"""

from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Dict

import cv2
import numpy as np
import torch

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data import augment as aug
from pdfnet_tpu_torch.data.loader import iter_batches
from pdfnet_tpu_torch.data.targets import centernet_targets
from pdfnet_tpu_torch.mano import layer as mano


def _root_rotation(R) -> np.ndarray:
    """A hand's root rotation as MANO takes it: (1, 3) axis-angle (the first
    three numbers of whatever shape it has) or (1, 3, 3)."""
    R = np.asarray(R, np.float32)
    return R.reshape(1, 3, 3) if R.ndim == 3 else R.reshape(1, -1)[:, :3]


class InterHandNewDataset:
    """The InterHandNew split under ``{cache_path}/InterHandNew``.
    ``native`` splats the heatmaps with the C++ helper (the JAX dataset's
    default, where its library builds) instead of numpy."""

    def __init__(self, cfg: Config, split: str, native: bool = True):
        self.cfg = cfg
        self.native = native
        self.split = "train" if split == "train_3d" else split
        self.root = os.path.join(cfg.cache_path, "InterHandNew")
        self.size = len(glob(os.path.join(self.root, self.split, "anno",
                                          "*.pkl")))
        if self.size == 0:
            raise FileNotFoundError(
                f"no InterHandNew annotations under {self.root}/{self.split}")
        self._consts = {s: mano.load_mano_consts(s, device="cpu")
                        for s in ("left", "right")}

    def __len__(self):
        return self.size

    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        res = cfg.default_resolution
        rng = np.random.RandomState(
            (cfg.seed + index * 31337 + epoch * 7919) % (2 ** 31))
        sp = self.split

        img = cv2.imread(os.path.join(self.root, sp, "img", f"{index}.jpg"))
        mask = cv2.imread(os.path.join(self.root, sp, "mask", f"{index}.jpg"))
        with open(os.path.join(self.root, sp, "anno", f"{index}.pkl"),
                  "rb") as f:
            anno = pickle.load(f)
        R = np.asarray(anno["camera"]["R"], np.float32)
        T = np.asarray(anno["camera"]["t"], np.float32).reshape(3)
        camera = np.asarray(anno["camera"]["camera"], np.float32)

        train = sp == "train"
        flip = train and rng.randint(0, 2) == 0
        if cfg.brightness and train and rng.randint(0, 2) == 0:
            img = aug.add_noise(img.astype(np.float32), rng).astype(np.uint8)
        if flip:
            img = cv2.flip(img, 1)
            mask = cv2.flip(mask, 1) if mask is not None else None

        t = lambda a, *shape: torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, np.float32).reshape(*shape)))
        hand = {}
        for side in ("left", "right"):
            p = anno["mano_params"][side]
            root = torch.from_numpy(_root_rotation(p["R"]))
            with torch.no_grad():
                v, j = mano.mano_forward(
                    self._consts[side], root, t(p["pose"], 1, 45),
                    t(p["shape"], 1, 10), trans=t(p["trans"], 1, 3))
            v = v[0].numpy() @ R.T + T
            j = j[0].numpy() @ R.T + T
            v2 = v @ camera.T
            v2 = v2[:, :2] / v2[:, 2:]
            j2 = j @ camera.T
            j2 = j2[:, :2] / j2[:, 2:]
            if flip:
                j2[:, 0] = img.shape[1] - j2[:, 0]
                v2[:, 0] = img.shape[1] - v2[:, 0]
                j[:, 0] = -j[:, 0]
                v[:, 0] = -v[:, 0]
            hand[side] = dict(verts3d=v, joints3d=j, verts2d=v2, joints2d=j2)
        if flip:
            hand["left"], hand["right"] = hand["right"], hand["left"]

        # single-stage augmentation: scale + center jitter + rotation
        H, W = img.shape[:2]
        c = np.array([W / 2.0, H / 2.0], np.float32)
        s = max(H, W) * 1.0
        rot = 0
        if train:
            s = s * rng.choice(np.arange(0.9, 1.1, 0.01))
            c += rng.randint(-5, 5, 2)
            rot = rng.randint(-90, 90)
        trans, _ = aug.get_affine_transform(c, s, rot, (res, res))
        img = cv2.warpAffine(img, trans, (res, res), flags=cv2.INTER_LINEAR)
        if mask is not None:
            mask = cv2.warpAffine(mask, trans, (res, res),
                                  flags=cv2.INTER_NEAREST)
        rot_point = aug.rotation_point_matrix(trans, camera, rot)
        for side in ("left", "right"):
            hand[side]["joints2d"] = aug.affine_transform_points(
                hand[side]["joints2d"], trans)
            hand[side]["verts2d"] = aug.affine_transform_points(
                hand[side]["verts2d"], trans)
            hand[side]["joints3d"] = hand[side]["joints3d"] @ rot_point.T
            hand[side]["verts3d"] = hand[side]["verts3d"] @ rot_point.T

        if mask is not None:
            _, mb = cv2.threshold(mask, 127, 255, cv2.THRESH_BINARY)
            mb = mb.astype(np.float32)[..., 1:] / 255.0
            if flip:
                mb = mb[..., ::-1]
        else:
            mb = np.zeros((res, res, 2), np.float32)

        tgt = centernet_targets(hand["left"]["joints2d"],
                                hand["right"]["joints2d"], 1, 1, res,
                                cfg.down_ratio, native=self.native)
        mean = np.asarray(cfg.mean, np.float32)
        std = np.asarray(cfg.std, np.float32)
        inp = (cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)
               / 255.0 - mean) / std

        n = cfg.sample_num
        return {
            "input": inp.astype(np.float32),
            "depth": np.zeros((res, res), np.float32),
            "cloud": np.zeros((2, n, 3), np.float32),
            "choose": np.zeros((2, n), np.int64),
            "hm": tgt["hm"], "hms": tgt["hms"], "wh": tgt["wh"],
            "off_hm": tgt["off_hm"], "off_lms": tgt["off_lms"],
            "ind": tgt["ind"], "valid": tgt["valid"],
            "mask": mb.astype(np.float32),
            "K_new": camera.astype(np.float32),
            "lms_left_gt": hand["left"]["joints2d"].astype(np.float32),
            "lms_right_gt": hand["right"]["joints2d"].astype(np.float32),
            "joints_left_gt": hand["left"]["joints3d"].astype(np.float32),
            "joints_right_gt": hand["right"]["joints3d"].astype(np.float32),
            "verts_left_gt": hand["left"]["verts3d"].astype(np.float32),
            "verts_right_gt": hand["right"]["verts3d"].astype(np.float32),
            "verts2d_left_gt": hand["left"]["verts2d"].astype(np.float32),
            "verts2d_right_gt": hand["right"]["verts2d"].astype(np.float32),
            "file_id": np.int64(index),
        }

    def batches(self, batch_size: int, epoch: int = 0,
                process_index: int = 0, process_count: int = 1):
        train = self.split == "train"
        return iter_batches(
            lambda j: self.__getitem__(j, epoch), len(self), batch_size,
            shuffle=train, seed=self.cfg.seed + epoch, pad_tail=not train,
            process_index=process_index, process_count=process_count)
