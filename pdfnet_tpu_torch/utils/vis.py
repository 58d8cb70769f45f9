"""Visualization: finger-colored skeleton drawing + landmark overlays (a copy
of ``pdfnet_tpu/utils/vis.py``, numpy and cv2).

Reference: showHandJoints (demo.py / simplified.py:1052-1146) — 21-joint
hand skeleton with per-finger colors and bone segments.
"""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np

# Per-joint colors (BGR), thumb->pinky gradients, as in the reference style.
JOINT_COLORS = np.array([
    [0, 0, 200],
    [0, 60, 255], [0, 120, 255], [0, 180, 255], [0, 240, 255],   # thumb
    [60, 255, 0], [120, 255, 0], [180, 255, 0], [240, 255, 0],   # index
    [255, 120, 0], [255, 180, 0], [255, 240, 0], [255, 255, 60], # middle
    [255, 0, 120], [255, 0, 180], [255, 0, 240], [255, 60, 255], # ring
    [120, 0, 255], [180, 0, 255], [240, 0, 255], [255, 0, 255],  # pinky
], np.uint8)

class AverageMeter:
    """Running mean tracker (lib/utils/utils.py:19-35)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        if self.count > 0:
            self.avg = self.sum / self.count


BONES = [(0, 1), (1, 2), (2, 3), (3, 4),
         (0, 5), (5, 6), (6, 7), (7, 8),
         (0, 9), (9, 10), (10, 11), (11, 12),
         (0, 13), (13, 14), (14, 15), (15, 16),
         (0, 17), (17, 18), (18, 19), (19, 20)]


def draw_hand_skeleton(img: np.ndarray, joints2d: np.ndarray,
                       out_path: Optional[str] = None) -> np.ndarray:
    """Draw a 21-joint skeleton onto an image (BGR uint8), in place."""
    img = np.ascontiguousarray(img).astype(np.uint8)
    for a, b in BONES:
        pa = tuple(np.round(joints2d[a]).astype(int))
        pb = tuple(np.round(joints2d[b]).astype(int))
        color = tuple(int(c) for c in JOINT_COLORS[b])
        cv2.line(img, pa, pb, color, 2)
    for j, (x, y) in enumerate(joints2d):
        color = tuple(int(c) for c in JOINT_COLORS[j])
        cv2.circle(img, (int(round(x)), int(round(y))), 3, color, -1)
    if out_path:
        cv2.imwrite(out_path, img)
    return img


def draw_landmarks(img: np.ndarray, lms: np.ndarray,
                   color=(0, 0, 255), size: int = 2) -> np.ndarray:
    img = np.ascontiguousarray(img).astype(np.uint8)
    for x, y in lms:
        cv2.circle(img, (int(x), int(y)), size, color, size)
    return img


def denormalize_image(inp: np.ndarray, mean, std) -> np.ndarray:
    """Undo dataset normalization: (H, W, 3) float RGB -> uint8 BGR."""
    img = np.clip((np.asarray(inp) * np.asarray(std) + np.asarray(mean))
                  * 255, 0, 255)
    return img.astype(np.uint8)[..., ::-1]


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Dump a mesh as Wavefront .obj (reference simplified.py:296-330
    pred/GT hand dumps; faces are 0-based, .obj is 1-based)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for tri in np.asarray(faces, np.int64) + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
