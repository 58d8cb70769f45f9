"""Host-side depth -> per-hand point-cloud sampling (port of
``pdfnet_tpu/data/cloud.py`` without its normals and FPS variants): the
numpy sampler, or the C++ one of ``pdfnet_tpu_torch.native`` when the caller
asks for it (``native=True``, as the JAX dataset does by default).

Mirrors the training-time sampling of the reference dataset
(interhand.py:758-905): band filtering around the mean hand depth, a random
subset or wrap padding to a fixed point count, and invalidity when a hand
has too few depth pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Z_MIN, Z_MAX = 0.2, 2.5
BAND = 0.08


def backproject_np(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(H, W) depth + (3, 3) K -> (H, W, 3) xyz."""
    H, W = depth.shape
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
    rays = pix @ np.linalg.inv(K).T.astype(np.float32)
    return rays * depth[..., None]


def sample_hand_cloud(masked_depth: np.ndarray, K: np.ndarray,
                      num_points: int, rng: np.random.RandomState,
                      min_pixels: int = 100, deterministic: bool = False,
                      native: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (choose (N,) flat pixel indices, cloud (N, 3) xyz, ok).

    ``deterministic``: the first ``num_points`` in-band pixels in sorted
    order (or wrap padding) with no shuffle; ``rng`` is then unused.
    ``native`` (random mode only): the C++ sampler, seeded with one draw of
    ``rng``; its subset is another uniform one than numpy's."""
    if native and not deterministic:
        from pdfnet_tpu_torch.native import sample_hand_cloud_native
        return sample_hand_cloud_native(
            masked_depth, K, num_points, seed=int(rng.randint(0, 2 ** 31)),
            min_pixels=min_pixels, z_min=Z_MIN, z_max=Z_MAX, band=BAND)
    invalid = (np.zeros(num_points, np.int64),
               np.zeros((num_points, 3), np.float32), False)
    xyz = backproject_np(masked_depth, K).reshape(-1, 3)
    z = xyz[:, 2]
    nz = z[z != 0]
    if len(nz) == 0:
        return invalid
    mean = nz.mean()
    lo, hi = max(Z_MIN, mean - BAND), min(Z_MAX, mean + BAND)
    choose = np.nonzero((z > lo) & (z < hi))[0]
    if len(choose) < min_pixels:
        return invalid
    if len(choose) > num_points:
        choose = (choose[:num_points] if deterministic
                  else rng.choice(choose, num_points, replace=False))
    else:
        choose = np.pad(choose, (0, num_points - len(choose)), "wrap")
    if not deterministic:
        rng.shuffle(choose)
    return choose.astype(np.int64), xyz[choose].astype(np.float32), True
