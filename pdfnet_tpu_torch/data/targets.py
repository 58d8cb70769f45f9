"""CenterNet target synthesis, host-side numpy (a copy of
``pdfnet_tpu/data/targets.py``), with the C++ splat of
``pdfnet_tpu_torch.native`` where the caller asks for it (``native=True``,
as the JAX package does when its native library builds).

References: gaussian_radius / draw_umich_gaussian (lib/utils/image.py:99-160),
target assembly (lib/datasets/interhand.py:917-963).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np


def gaussian_radius(det_size: Tuple[float, float],
                    min_overlap: float = 0.7) -> float:
    height, width = det_size
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2
    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


@functools.lru_cache(maxsize=64)
def gaussian2d(shape: Tuple[int, int], sigma: float = 1.0) -> np.ndarray:
    """Cached (a hand's 21 keypoints share one radius); read-only."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0,
                  native: bool = False):
    """In-place max-composited gaussian splat (draw_umich_gaussian);
    ``native``: the C++ splat (float32 gaussian, k = 1)."""
    if native:
        if k != 1.0:
            raise ValueError("draw_gaussian: the native splat takes k = 1")
        from pdfnet_tpu_torch.native import draw_gaussian_native
        draw_gaussian_native(heatmap, center, radius)
        return heatmap
    diameter = 2 * radius + 1
    gaussian = gaussian2d((diameter, diameter), sigma=diameter / 6.0)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape
    if x < 0 or y < 0 or x >= width or y >= height:
        return heatmap
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    masked = heatmap[y - top:y + bottom, x - left:x + right]
    g = gaussian[radius - top:radius + bottom, radius - left:radius + right]
    np.maximum(masked, g * k, out=masked)
    return heatmap


def centernet_targets(lms_left: Optional[np.ndarray],
                      lms_right: Optional[np.ndarray], valid_left: int,
                      valid_right: int, resolution: int = 384, down: int = 4,
                      num_classes: int = 2, native: bool = False
                      ) -> Dict[str, np.ndarray]:
    """hm / hms / wh / ind / off targets from (21, 2) full-resolution pixel
    landmarks per hand (or None); ``native``: splat with the C++ helper."""
    hw = resolution // down
    hm = np.zeros((num_classes, hw, hw), np.float32)
    hm_lms = np.zeros((42, hw, hw), np.float32)
    wh = np.zeros((2, 2), np.float32)
    off_hm = np.zeros((2, 2), np.float32)
    off_lms = np.zeros((2, 42), np.float32)
    ind = np.zeros((2,), np.int64)
    reg_mask = np.zeros((2,), np.uint8)

    for hand, lms, v in ((0, lms_left, valid_left), (1, lms_right, valid_right)):
        if not v or lms is None:
            continue
        # bbox over landmarks with both coordinates positive, like the
        # reference lms2bbox (interhand.py:45-61); zero box if none qualify
        pos = lms[(lms[:, 0] > 0) & (lms[:, 1] > 0)]
        if len(pos) == 0:
            lo = hi = np.zeros(2, lms.dtype)
        else:
            lo, hi = pos.min(axis=0), pos.max(axis=0)
        ct = (lo + hi) / 2.0
        w = (hi[0] - lo[0]) / 0.7 / down
        h = (hi[1] - lo[1]) / 0.7 / down
        radius = max(0, int(gaussian_radius((np.ceil(h), np.ceil(w)))))
        ct_int = (ct / down).astype(np.int32)
        lms_down = lms / down
        for kk in range(21):
            draw_gaussian(hm_lms[hand * 21 + kk],
                          lms_down[kk].astype(np.int32), radius,
                          native=native)
            off_lms[hand, kk * 2:kk * 2 + 2] = lms_down[kk] - ct_int
        draw_gaussian(hm[hand], ct_int, radius, native=native)
        wh[hand] = (w, h)
        ind[hand] = ct_int[1] * hw + ct_int[0]
        off_hm[hand] = ct / down - ct_int
        reg_mask[hand] = 1

    ind = np.where((ind < 0) | (ind >= hw * hw), 0, ind)
    return {"hm": hm.transpose(1, 2, 0), "hms": hm_lms.transpose(1, 2, 0),
            "wh": wh, "ind": ind, "off_hm": off_hm, "off_lms": off_lms,
            "valid": reg_mask.astype(np.float32)}
