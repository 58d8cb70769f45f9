"""H2O / H2O3D / RHD dataset pipeline, host-side numpy/cv2 (port of
``pdfnet_tpu/data/h2o.py``: ``build_mano_gt_cache``, ``mano_gt_from_coeff``,
``decode_rhd_depth``, ``H2ODataset``, ``build_dataset``).

Reference: lib/datasets/joint_dataset.py (cache loading / split slicing) and
lib/datasets/interhand.py:459-1023 (sample building: MANO GT synthesis,
flip/brightness/jitter/rotation augmentation, two-stage affine warp with
intrinsics update, mask binarization, depth->cloud sampling, CenterNet
targets).

Annotation caches are pickles ``{cache_path}/{dataset}_{split}.pkl`` holding
a list of dicts with keys imgpath / depthpath / mano_coeff (124) / lms
(42, 2) / joints (42, 3) / K (3, 3) [+ id for test].  GT meshes come from
the port's MANO layer on the CPU, computed once per record list into a disk
cache whose name carries ``_torch``: the JAX package's MANO agrees with it
only to float32 rounding, so neither package reads the other's cache.

The host helpers are chosen by the ``native`` argument: the C++ cloud
sampler and gaussian splat of ``pdfnet_tpu_torch.native`` (the JAX
dataset's default, where its library builds), or the numpy versions.
``input_feature_num=6`` appends surface normals to the clouds and
``sample_strategy="FPS"`` reorders them by two-level FPS, drawing from the
sample's numpy stream after both hands are sampled, as the JAX dataset does.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import zlib
from typing import Dict, List, Optional

import cv2
import numpy as np
import torch

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data import augment as aug
from pdfnet_tpu_torch.data.cloud import fps_reorder_cloud, sample_hand_cloud
from pdfnet_tpu_torch.data.targets import centernet_targets
from pdfnet_tpu_torch.mano import layer as mano

DATASET_INDEX = {"Joint": 0, "FreiHAND": 1, "HO3D": 2, "H2O": 3, "H2O3D": 4,
                 "InterHand": 5, "RHD": 6, "Others": 7}


_CONSTS: Dict[tuple, mano.ManoConsts] = {}


def _mano_consts(side: str, fix_shape: bool) -> mano.ManoConsts:
    key = (side, fix_shape)
    if key not in _CONSTS:
        _CONSTS[key] = mano.load_mano_consts(side, fix_shape=fix_shape,
                                             device="cpu")
    return _CONSTS[key]


def _mano_forward(side: str, fix_shape: bool, c: np.ndarray):
    """MANO on the CPU for per-hand coefficients c (B, 62) [valid, trans3,
    orient3, pose45, shape10] -> (verts (B, 778, 3), joints (B, 21, 3))."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    with torch.no_grad():
        v, j = mano.mano_forward(_mano_consts(side, fix_shape),
                                 t(c[:, 4:7]), t(c[:, 7:52]),
                                 t(c[:, 52:62]), trans=t(c[:, 1:4]))
    return v.numpy(), j.numpy()


@contextlib.contextmanager
def _host_threads():
    """torch's intra-op pool limited to the cores this process may run on
    (``os.sched_getaffinity``): torch sizes it by the machine's cores, which
    oversubscribes a container that owns only some of them."""
    prev = torch.get_num_threads()
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:          # pragma: no cover (not Linux)
        cores = os.cpu_count() or 1
    torch.set_num_threads(max(1, min(prev, cores)))
    try:
        yield
    finally:
        torch.set_num_threads(prev)


_MANO_CACHE_CHUNK = 256


def build_mano_gt_cache(records: List[Dict], cache_path: str,
                        tag: str, fix_shape: bool = True,
                        ) -> Optional[Dict[str, np.ndarray]]:
    """Precompute per-record MANO GT (verts/joints, both hands) to a disk
    memmap, keyed by a checksum of the mano coefficients.

    The reference re-runs the ManoLayer forward inside every __getitem__
    (interhand.py:555-587) — ~20 ms/sample of pure recomputation, since the
    output depends only on the per-record ``mano_coeff``.  Augmentation
    (flip/rotation) is applied AFTER this cache in __getitem__.

    The port's MANO runs on the CPU in chunks of ``_MANO_CACHE_CHUNK``
    records, in the constructor (before any loader thread starts), with
    torch's intra-op pool held to this process's cores.  The file name ends
    in ``_torch_verts.npy`` / ``_torch_joints.npy``: the JAX package's cache
    in the same ``cache_path`` agrees only to float32 rounding and is never
    read here.

    Returns {'verts': (R, 2, 778, 3) f32 memmap, 'joints': (R, 2, 21, 3)}
    or None when records carry no mano_coeff.
    """
    if not records or "mano_coeff" not in records[0]:
        return None
    coeffs = np.stack([np.asarray(r["mano_coeff"], np.float32).reshape(-1)
                       for r in records])                       # (R, 124)
    key = zlib.crc32(coeffs.tobytes()) & 0xFFFFFFFF
    sfx = ("" if fix_shape else "_nofix") + "_torch"
    base = os.path.join(cache_path,
                        f"{tag}_manogt_{len(records)}_{key:08x}{sfx}")
    vp, jp = base + "_verts.npy", base + "_joints.npy"
    if not (os.path.exists(vp) and os.path.exists(jp)):
        R = len(records)
        verts = np.empty((R, 2, 778, 3), np.float32)
        joints = np.empty((R, 2, 21, 3), np.float32)
        n = _MANO_CACHE_CHUNK
        pad = (-R) % n
        cp = np.concatenate([coeffs, np.zeros((pad, 124), np.float32)])
        with _host_threads():
            for s, (side, off) in enumerate((("left", 0), ("right", 62))):
                for i in range(0, R + pad, n):
                    v, j = _mano_forward(side, fix_shape,
                                         cp[i:i + n, off:off + 62])
                    stop = min(i + n, R)
                    verts[i:stop, s] = v[:stop - i]
                    joints[i:stop, s] = j[:stop - i]
        # atomic publish: concurrent builders race benignly
        for path, arr in ((vp, verts), (jp, joints)):
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:     # np.save(str) would append .npy
                np.save(f, arr)
            os.replace(tmp, path)
    return {"verts": np.load(vp, mmap_mode="r"),
            "joints": np.load(jp, mmap_mode="r")}


def mano_gt_from_coeff(coeff: np.ndarray, side: str, fix_shape: bool = True):
    """(62,) per-hand coeff [valid, trans3, orient3, pose45, shape10] ->
    (verts 778x3, joints 21x3) in camera space."""
    v, j = _mano_forward(side, fix_shape, np.asarray(coeff)[None])
    return v[0], j[0]


def decode_rhd_depth(depth_img: np.ndarray) -> np.ndarray:
    """RHD's 2-channel uint8 depth encoding -> meters (interhand.py:181-186)."""
    top, bottom = depth_img[:, :, 2], depth_img[:, :, 1]
    return ((top.astype(np.float32) * 256 + bottom) / (2 ** 16 - 1)) * 5.0


class H2ODataset:
    """Split-sliced dataset over the pickle annotation caches.  ``native``
    picks the C++ host helpers (cloud sampler, gaussian splat) over the
    numpy versions."""

    def __init__(self, cfg: Config, split: str, native: bool = True):
        self.cfg = cfg
        self.split = split
        self.native = native
        self.rng = np.random.RandomState(cfg.seed)
        name = cfg.dataset
        self.records: List[Dict] = []
        cache = os.path.join(cfg.cache_path, f"{name}_{split}.pkl")
        if not os.path.exists(cache):
            raise FileNotFoundError(
                f"annotation cache {cache} not found; place the {name} "
                f"caches under {cfg.cache_path}/ or use the synthetic dataset")
        self.records += self._load(cache, name)
        if split == "train" and name == "H2O":
            val_cache = os.path.join(cfg.cache_path, f"{name}_val.pkl")
            if os.path.exists(val_cache):
                self.records += self._load(val_cache, name)
        self.records = self._slice_split(self.records, name, split)
        # quirks mode reproduces the reference H2O branch's UNFIXED left
        # shapedirs in GT synthesis (fix_shape only runs on the reference's
        # InterHandNew branch, interhand.py:120-123,194)
        self._fix_shape = not cfg.replicate_reference_quirks
        self._mano_gt = build_mano_gt_cache(
            self.records, cfg.cache_path, f"{name}_{split}",
            fix_shape=self._fix_shape)

    @staticmethod
    def _slice_split(records: List[Dict], name: str, split: str) -> List[Dict]:
        """Per-dataset split slicing (joint_dataset.py:86-127 prepare_data):
        FreiHAND/HO3D slice the first+last 3000 records for val, OneHand10K
        the first+last 1000 for test, H2O tests on the first 100; everything
        else passes through.  Note the asymmetry is the reference's own:
        HO3D excludes the val slice from train ([3000:-3000]) but FreiHAND
        trains on all records including the val slice
        (joint_dataset.py:90-97)."""
        if name == "FreiHAND":
            if split == "val":
                return records[:3000] + records[-3000:]
            return records
        if name in ("HO3D", "HO3Dv3"):
            if split == "val":
                return records[:3000] + records[-3000:]
            if split == "test":
                return records
            return records[3000:-3000]
        if name == "OneHand10K":
            if split == "test":
                return records[:1000] + records[-1000:]
            if split == "eval":
                return records
            return records[1000:-1000]
        if name == "H2O" and split == "test":
            return records[:100]
        return records

    def _load(self, cache: str, name: str) -> List[Dict]:
        with open(cache, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        for item in data:
            # datasets without a dedicated index (OneHand10K, HO3Dv3, ...)
            # fall into the reference's 'Others' bucket (joint_dataset.py:20)
            item["dataset"] = DATASET_INDEX.get(name, DATASET_INDEX["Others"])
            item["imgpath"] = os.path.join(name, item["imgpath"])
            if "depthpath" in item:
                item["depthpath"] = os.path.join(name, item["depthpath"])
        return data

    def __len__(self):
        return len(self.records)

    # ------------------------------------------------------------------
    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rec = self.records[index]
        # per-(sample, epoch) seed: deterministic across workers/restarts but
        # the augmentation draw changes every epoch
        rng = np.random.RandomState(
            (cfg.seed + index * 9973 + epoch * 7919) % (2 ** 31))
        res = cfg.default_resolution

        img = cv2.imread(os.path.join(cfg.pre_fix, rec["imgpath"]))
        has_depth = "depthpath" in rec
        if not has_depth:
            # RGB-only datasets (FreiHAND; joint_dataset.py records carry no
            # depthpath): zero depth -> zero-padded clouds.  Validity is NOT
            # demoted (unlike a failed depth sample) so the image-side
            # supervision and the FreiHAND eval kit stay reachable.
            depth = np.zeros(img.shape[:2], np.float32)
        elif cfg.dataset == "RHD":
            d_raw = cv2.imread(os.path.join(cfg.pre_fix, rec["depthpath"]))
            depth = decode_rhd_depth(d_raw)
        else:
            depth = cv2.imread(os.path.join(cfg.pre_fix, rec["depthpath"]),
                               cv2.IMREAD_ANYDEPTH) / 1000.0
        mask_rel = (rec["imgpath"].replace("rgb", "mask")
                    if cfg.dataset == "H2O"
                    else rec["imgpath"].replace("color", "mask"))
        mask = cv2.imread(os.path.join(cfg.pre_fix, mask_rel))
        H, W = img.shape[:2]
        if mask is not None and mask.shape[:2] != (H, W):
            mask = cv2.resize(mask, (W, H))

        K = np.asarray(rec["K"], np.float32).reshape(3, 3)
        fx, cx = K[0, 0], K[0, 2]
        lms_raw = np.asarray(rec["lms"], np.float32)
        if lms_raw.ndim == 2 and lms_raw.shape[1] == 3:
            # RHD caches carry (42, 3) x/y/confidence rows; keep the xy and
            # the confidence column (validity, interhand.py:736-746).
            lms_conf = lms_raw[:, 2].copy()
            lms = lms_raw[:, :2].copy()
        else:
            lms_conf = None
            lms = lms_raw.reshape(-1, 2).copy()

        train = self.split == "train"
        flip = train and rng.randint(0, 2) == 0

        # --- MANO GT (H2O) or joint GT (RHD) -------------------------------
        hand = {}
        if "mano_coeff" in rec:
            coeff = np.asarray(rec["mano_coeff"], np.float32).reshape(-1)
            for si, (side, sl) in enumerate(
                    (("left", slice(0, 62)), ("right", slice(62, 124)))):
                if self._mano_gt is not None:
                    # writable copies: flip aug below mutates in place
                    v = np.array(self._mano_gt["verts"][index, si])
                    j = np.array(self._mano_gt["joints"][index, si])
                else:
                    v, j = mano_gt_from_coeff(coeff[sl], side,
                                              self._fix_shape)
                # invalid hands carry a zero coeff -> template hand at the
                # origin whose z can cross 0; the projections must stay
                # finite (a gated loss term still NaNs on inf * 0)
                v2 = v @ K.T
                v2 = np.nan_to_num(v2[:, :2] / v2[:, 2:],
                                   posinf=0.0, neginf=0.0)
                j2 = j @ K.T
                j2 = np.nan_to_num(j2[:, :2] / j2[:, 2:],
                                   posinf=0.0, neginf=0.0)
                if flip:
                    j2[:, 0] = W - j2[:, 0]
                    v2[:, 0] = W - v2[:, 0]
                    j[:, 0] = -j[:, 0] + j[:, 2] / fx * (W - 2 * cx)
                    v[:, 0] = -v[:, 0] + v[:, 2] / fx * (W - 2 * cx)
                hand[side] = dict(verts3d=v, joints3d=j, verts2d=v2, joints2d=j2)
            valid_l = 1 if coeff[0] == 1 else 0
            valid_r = 1 if coeff[62] == 1 else 0
        else:  # RHD: joints only
            joints = np.asarray(rec["joints"], np.float32).reshape(-1, 3)
            for side, jj, l2 in (("left", joints[:21], lms[:21].copy()),
                                 ("right", joints[21:], lms[21:].copy())):
                j = jj.copy()
                if flip:
                    l2[:, 0] = W - l2[:, 0]
                    j[:, 0] = -j[:, 0] + j[:, 2] / fx * (W - 2 * cx)
                hand[side] = dict(verts3d=None, joints3d=j, verts2d=None,
                                  joints2d=l2)
            # valid iff the bbox exists AND >10 of 21 keypoints are visible
            # (reference interhand.py:736-746; the flip swap below mirrors
            # the reference's flipped-validity branch).
            bboxes = rec.get("bboxes", [1, 1])
            valid_l = int(bboxes[0] is not None and
                          (lms_conf is None or lms_conf[:21].sum() > 10))
            valid_r = int(bboxes[1] is not None and
                          (lms_conf is None or lms_conf[21:].sum() > 10))

        if cfg.brightness and train and rng.randint(0, 2) == 0:
            # add_noise converts to f32 itself; no pre-copy
            img = aug.add_noise(img, rng).astype(np.uint8)
        if flip:
            img = cv2.flip(img, 1)
            mask = cv2.flip(mask, 1) if mask is not None else None
            depth = cv2.flip(depth, 1)
            lms[:, 0] = W - lms[:, 0]
            hand["left"], hand["right"] = hand["right"], hand["left"]
            valid_l, valid_r = valid_r, valid_l

        # --- stage 1: center crop (+jitter) with intrinsics update ---------
        c = np.array([W / 2.0, H / 2.0], np.float32)
        s = max(H, W) * 1.0
        rot = 0
        if train:
            c[0] = rng.randint(int(c[0] - 5), int(c[0] + 5))
            c[1] = rng.randint(int(c[1] - 5), int(c[1] + 5))
            rot = rng.randint(-60, 60)
        trans, _ = aug.get_affine_transform(c, s, 0, (res, res))
        K_img = aug.update_intrinsics(K, trans)
        img = cv2.warpAffine(img, trans, (res, res), flags=cv2.INTER_LINEAR)
        depth = cv2.warpAffine(depth, trans, (res, res), flags=cv2.INTER_NEAREST)
        if mask is not None:
            mask = cv2.warpAffine(mask, trans, (res, res),
                                  flags=cv2.INTER_NEAREST)
        lms = aug.affine_transform_points(lms, trans)
        for side in ("left", "right"):
            hand[side]["joints2d"] = aug.affine_transform_points(
                hand[side]["joints2d"], trans)
            if hand[side]["verts2d"] is not None:
                hand[side]["verts2d"] = aug.affine_transform_points(
                    hand[side]["verts2d"], trans)

        # --- stage 2: in-plane rotation, K kept fixed ----------------------
        c2 = np.array([res / 2.0, res / 2.0], np.float32)
        trans2, _ = aug.get_affine_transform(c2, float(res), rot, (res, res))
        img = cv2.warpAffine(img, trans2, (res, res), flags=cv2.INTER_LINEAR)
        depth = cv2.warpAffine(depth, trans2, (res, res),
                               flags=cv2.INTER_NEAREST)
        if mask is not None:
            mask = cv2.warpAffine(mask, trans2, (res, res),
                                  flags=cv2.INTER_NEAREST)
        lms = aug.affine_transform_points(lms, trans2)
        rot_point = aug.rotation_point_matrix(trans2, K_img, rot)
        for side in ("left", "right"):
            hand[side]["joints2d"] = aug.affine_transform_points(
                hand[side]["joints2d"], trans2)
            hand[side]["joints3d"] = hand[side]["joints3d"] @ rot_point.T
            if hand[side]["verts2d"] is not None:
                hand[side]["verts2d"] = aug.affine_transform_points(
                    hand[side]["verts2d"], trans2)
                hand[side]["verts3d"] = hand[side]["verts3d"] @ rot_point.T

        # --- masks to per-hand binary --------------------------------------
        if mask is not None and cfg.dataset == "H2O":
            _, mask_bin = cv2.threshold(mask, 127, 255, cv2.THRESH_BINARY)
            mask_bin = mask_bin.astype(np.float32)[..., 1:] / 255.0  # (H,W,2)
            if flip:
                mask_bin = mask_bin[..., ::-1]
            mask_right, mask_left = mask_bin[..., 0], mask_bin[..., 1]
        elif mask is not None and cfg.dataset in ("HO3D", "HO3Dv3",
                                                  "FreiHAND", "OneHand10K"):
            # single-right-hand datasets: hand is the red blob (HO3D masks
            # are red-hand/blue-object, interhand.py:512 comment)
            mask_right = (mask[:, :, 2] > 100).astype(np.float32)
            mask_left = np.zeros_like(mask_right)
            if flip:
                mask_left, mask_right = mask_right, mask_left
            mask_bin = np.stack([mask_right, mask_left], axis=-1)
        elif mask is not None:  # RHD label ids
            mask_left = (((mask[:, :, 0] > 1) & (mask[:, :, 0] < 18))
                         .astype(np.float32))
            mask_right = (mask[:, :, 0] >= 18).astype(np.float32)
            if flip:
                mask_left, mask_right = mask_right, mask_left
            mask_bin = np.stack([mask_right, mask_left], axis=-1)
        else:
            mask_bin = np.zeros((res, res, 2), np.float32)
            mask_right = mask_left = mask_bin[..., 0]

        # --- point clouds ---------------------------------------------------
        band = ((depth > 0.2) & (depth < 2.5)).astype(np.float32)
        depth_b = depth * band
        n = cfg.sample_num
        normals = cfg.input_feature_num == 6
        det = cfg.deterministic_cloud_sampling
        choose_l, cloud_l, ok_l = sample_hand_cloud(depth_b * mask_left,
                                                    K_img, n, rng,
                                                    deterministic=det,
                                                    native=self.native,
                                                    with_normals=normals)
        choose_r, cloud_r, ok_r = sample_hand_cloud(depth_b * mask_right,
                                                    K_img, n, rng,
                                                    deterministic=det,
                                                    native=self.native,
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
        if has_depth:          # a failed depth sample demotes the hand
            valid_l = valid_l and ok_l
            valid_r = valid_r and ok_r

        tgt = centernet_targets(hand["left"]["joints2d"],
                                hand["right"]["joints2d"],
                                int(valid_l), int(valid_r), res,
                                cfg.down_ratio, native=self.native)

        mean = np.asarray(cfg.mean, np.float32)
        std = np.asarray(cfg.std, np.float32)
        # in-place normalization: one allocation instead of three full-image
        # temporaries, and np.asarray instead of astype below (astype COPIES
        # even when the dtype already matches — these were ~8 ms/sample)
        inp = img.astype(np.float32)
        inp /= 255.0
        inp -= mean
        inp /= std
        f32 = lambda x: np.asarray(x, np.float32)

        out = {
            "input": inp,
            "depth": f32(depth),
            "cloud": f32(np.stack([cloud_l, cloud_r])),
            "choose": np.stack([choose_l, choose_r]),
            "hm": tgt["hm"], "hms": tgt["hms"], "wh": tgt["wh"],
            "off_hm": tgt["off_hm"], "off_lms": tgt["off_lms"],
            "ind": tgt["ind"],
            "valid": tgt["valid"],
            "mask": f32(mask_bin),
            "mask_left_gt": f32(mask_left),
            "mask_right_gt": f32(mask_right),
            "lms": f32(lms),
            "K_new": f32(K_img),
            "lms_left_gt": f32(hand["left"]["joints2d"]),
            "lms_right_gt": f32(hand["right"]["joints2d"]),
            "joints_left_gt": f32(hand["left"]["joints3d"]),
            "joints_right_gt": f32(hand["right"]["joints3d"]),
            "file_id": np.int64(index),
        }
        if hand["left"]["verts3d"] is not None:
            out.update({
                "verts_left_gt": f32(hand["left"]["verts3d"]),
                "verts_right_gt": f32(hand["right"]["verts3d"]),
                "verts2d_left_gt": f32(hand["left"]["verts2d"]),
                "verts2d_right_gt": f32(hand["right"]["verts2d"]),
            })
        if "id" in rec and self.split == "test":
            out["id"] = np.int64(rec["id"])
            out["frame_num"] = np.int64(int(rec["imgpath"][-10:-4]))
        return out

    def batches(self, batch_size: int, epoch: int = 0,
                process_index: int = 0, process_count: int = 1):
        from pdfnet_tpu_torch.data.loader import iter_batches
        train = self.split == "train"
        return iter_batches(
            lambda j: self.__getitem__(j, epoch), len(self), batch_size,
            shuffle=train, seed=self.cfg.seed + epoch,
            workers=max(int(self.cfg.num_workers), 1), pad_tail=not train,
            process_index=process_index, process_count=process_count)


def build_dataset(cfg: Config, split: str, synthetic: bool = False,
                  native: bool = True):
    """Dataset factory.  ``synthetic`` must be requested EXPLICITLY — a
    typo'd --cache_path must fail loudly (H2ODataset raises
    FileNotFoundError with the path), never silently train on random
    synthetic hands."""
    if synthetic:
        from pdfnet_tpu_torch.data.synthetic import SyntheticHandDataset
        return SyntheticHandDataset(cfg, size=256 if split == "train" else 32,
                                    seed=0 if split == "train" else 1,
                                    train=split == "train")
    return H2ODataset(cfg, split, native=native)
