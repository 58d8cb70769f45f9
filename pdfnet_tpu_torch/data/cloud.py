"""Host-side depth -> per-hand point-cloud sampling (port of
``pdfnet_tpu/data/cloud.py``): the numpy sampler, or the C++ one of
``pdfnet_tpu_torch.native`` when the caller asks for it (``native=True``, as
the JAX dataset does by default), surface normals at the sampled pixels
(``input_feature_num=6``) and the two-level FPS reordering
(``sample_strategy="FPS"``).

Mirrors the training-time sampling of the reference dataset
(interhand.py:758-905): band filtering around the mean hand depth, a random
subset or wrap padding to a fixed point count, and invalidity when a hand
has too few depth pixels.  Every function here is a numpy copy of the JAX
package's and gives the same bits on the same inputs and RNG state.
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


def normals_at_indices_np(points: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """LS plane-fit surface normals at flat pixel indices of an (H, W, 3) map.

    The reference's get_normal (lib/utils/utils.py:264-310): 5x5 dilation-2
    neighbourhood ({-4,-2,0,2,4}^2 offsets), zero padding, a
    determinant-guarded A^T A solve against ones, L2 normalization; computed
    at the ``idx`` sample locations only, which is exact.
    """
    H, W, _ = points.shape
    p = np.pad(points, ((4, 4), (4, 4), (0, 0)))
    ys, xs = idx // W + 4, idx % W + 4
    offs = np.array([-4, -2, 0, 2, 4])
    oy, ox = np.meshgrid(offs, offs, indexing="ij")
    nbrs = p[ys[:, None] + oy.ravel()[None, :],
             xs[:, None] + ox.ravel()[None, :]]            # (N, 25, 3)
    ata = np.einsum("nki,nkj->nij", nbrs, nbrs)
    atb = nbrs.sum(axis=1)
    det = np.linalg.det(ata)
    safe = np.where((det >= 1e-5)[:, None, None], ata,
                    np.eye(3, dtype=points.dtype))
    n = np.linalg.solve(safe, atb[..., None])[..., 0]
    return (n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
            ).astype(np.float32)


def fps_order_host(points: np.ndarray, num_samples: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """Greedy farthest-point ordering (reference interhand.py:147-178) from a
    start drawn from ``rng``: the picks first, in pick order, then the rest
    ascending; a full permutation of the n points."""
    n = len(points)
    if n <= num_samples:
        return np.arange(n)
    sel = np.zeros(num_samples, np.int64)
    sel[0] = rng.randint(n)
    diff = points - points[sel[0]]
    min_dist = np.sum(diff * diff, axis=1)
    for i in range(1, num_samples):
        sel[i] = int(np.argmax(min_dist))
        diff = points - points[sel[i]]
        min_dist = np.minimum(min_dist, np.sum(diff * diff, axis=1))
    # wrap-padded clouds repeat points, so argmax re-picks an index once
    # every distance is zero: keep first occurrences (the reference dedupes
    # too, interhand.py:177)
    sel = sel[np.sort(np.unique(sel, return_index=True)[1])]
    rest = np.setdiff1d(np.arange(n), sel, assume_unique=False)
    return np.concatenate([sel, rest])


def fps_reorder_cloud(cloud: np.ndarray, choose: np.ndarray,
                      num_level1: int, num_level2: int,
                      rng: np.random.RandomState):
    """Two-level FPS reordering of a sampled hand cloud and its pixel
    indices: level-1 centers first among all points, level-2 centers first
    within the level-1 prefix."""
    order1 = fps_order_host(cloud[:, :3], num_level1, rng)
    cloud, choose = cloud[order1], choose[order1]
    order2 = fps_order_host(cloud[:num_level1, :3], num_level2, rng)
    cloud[:num_level1] = cloud[:num_level1][order2]
    choose[:num_level1] = choose[:num_level1][order2]
    return cloud, choose


def sample_hand_cloud(masked_depth: np.ndarray, K: np.ndarray,
                      num_points: int, rng: np.random.RandomState,
                      min_pixels: int = 100, deterministic: bool = False,
                      native: bool = False, with_normals: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (choose (N,) flat pixel indices, cloud (N, 3) xyz or, with
    ``with_normals``, (N, 6) xyz + normals, ok).

    ``deterministic``: the first ``num_points`` in-band pixels in sorted
    order (or wrap padding) with no shuffle; ``rng`` is then unused.
    ``native`` (random mode only): the C++ sampler, seeded with one draw of
    ``rng``; its subset is another uniform one than numpy's."""
    feat = 6 if with_normals else 3
    invalid = (np.zeros(num_points, np.int64),
               np.zeros((num_points, feat), np.float32), False)
    if native and not deterministic:
        from pdfnet_tpu_torch.native import sample_hand_cloud_native
        choose, cloud, ok = sample_hand_cloud_native(
            masked_depth, K, num_points, seed=int(rng.randint(0, 2 ** 31)),
            min_pixels=min_pixels, z_min=Z_MIN, z_max=Z_MAX, band=BAND)
        if not with_normals:
            return choose, cloud, ok
        if not ok:
            return invalid
        pts = backproject_np(masked_depth, K)
        return choose, np.concatenate(
            [cloud, normals_at_indices_np(pts, choose)], axis=1), ok
    pts_map = backproject_np(masked_depth, K)
    xyz = pts_map.reshape(-1, 3)
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
    cloud = xyz[choose].astype(np.float32)
    if with_normals:
        cloud = np.concatenate(
            [cloud, normals_at_indices_np(pts_map, choose)], axis=1)
    return choose.astype(np.int64), cloud, True
