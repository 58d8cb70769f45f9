"""Host-side image augmentation + affine crop utilities (numpy/cv2): a copy
of ``pdfnet_tpu/data/augment.py``.

References: get_affine_transform / affine_transform_array
(lib/utils/image.py:27-71), add_noise (lib/utils/data_augment.py:8-40),
intrinsics update under crop (interhand.py:641-648), in-plane-rotation
3D point transform (interhand.py:666-696).
"""

from __future__ import annotations

from typing import Optional, Tuple

import cv2
import numpy as np


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """CenterNet-style crop transform; returns (trans 2x3, inv_trans 2x3)."""
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], dtype=np.float32)
    scale = np.asarray(scale, np.float32)
    shift = np.asarray(shift, np.float32)
    src_w = scale[0]
    dst_w, dst_h = output_size

    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    # "up" vector rotated by rot (image.py get_dir)
    src_point = np.array([0, src_w * -0.5], np.float32)
    src_dir = np.array([src_point[0] * cs - src_point[1] * sn,
                        src_point[0] * sn + src_point[1] * cs], np.float32)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    src[2] = third(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])

    trans = cv2.getAffineTransform(np.float32(src), np.float32(dst))
    inv = cv2.getAffineTransform(np.float32(dst), np.float32(src))
    return trans.astype(np.float32), inv.astype(np.float32)


def affine_transform_points(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(N, 2) points through a 2x3 affine."""
    homog = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    return (t @ homog.T).T.astype(np.float32)


def update_intrinsics(K: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Fold an axis-aligned crop/scale affine into the intrinsics."""
    K2 = K.copy()
    K2[0, 0] = K[0, 0] * trans[0, 0]
    K2[1, 1] = K[1, 1] * trans[1, 1]
    K2[0, 2] = K[0, 2] * trans[0, 0] + trans[0, 2]
    K2[1, 2] = K[1, 2] * trans[1, 1] + trans[1, 2]
    return K2


def rotation_point_matrix(trans_rot: np.ndarray, K: np.ndarray,
                          rot_deg: float) -> np.ndarray:
    """3x3 camera-space transform matching an in-plane image rotation.

    After rotating the cropped image by ``trans_rot`` (K unchanged), 3D
    points must be mapped so their projections follow; the transform acts on
    xy with the rotation block and shifts by depth-scaled offsets derived
    from how the principal point moved (interhand.py:684-691).
    """
    cx, cy, fx, fy = K[0, 2], K[1, 2], K[0, 0], K[1, 1]
    tx, ty = trans_rot[0, 2], trans_rot[1, 2]
    t0 = (trans_rot[0, 0] * cx + trans_rot[0, 1] * cy + tx - cx) / (fx + 1e-7)
    t1 = (trans_rot[1, 0] * cx + trans_rot[1, 1] * cy + ty - cy) / (fy + 1e-7)
    r = rot_deg / 180.0 * np.pi
    m = np.array([[np.cos(r), np.sin(r), t0],
                  [-np.sin(r), np.cos(r), t1],
                  [0, 0, 1]], np.float32)
    m[:2, :2] = trans_rot[:2, :2]
    return m


def add_noise(img: np.ndarray, rng: Optional[np.random.RandomState] = None,
              noise: float = 0.0, scale: float = 255.0,
              alpha: float = 0.3, beta: float = 0.05) -> np.ndarray:
    """Brightness/contrast jitter: img * a + b*scale + gaussian noise."""
    rng = rng or np.random.RandomState()
    a = rng.uniform(1 - alpha, 1 + alpha)
    b = rng.uniform(-beta, beta) * scale
    out = img.astype(np.float32) * a + b
    if noise > 0:
        out = out + rng.normal(0, noise, img.shape)
    return np.clip(out, 0, 255)
