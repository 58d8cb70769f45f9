"""Depth map + per-hand masks -> fixed-size per-hand point clouds on the
device (port of ``pdfnet_tpu/ops/pointcloud.py:24-185``).

Per hand: mask the depth, keep [Z_MIN, Z_MAX], band-filter around the mean
masked depth (+-BAND), then take exactly ``num_points`` in-band pixels (a
subset when there are more, wrap-padded when fewer; all zero when the hand
has fewer than MIN_PIXELS or is not valid) and lift them to camera xyz with
K^-1.  Everything is fixed-shape tensor work with no host synchronisation
(no ``nonzero()``, no ``.item()``, no branch on data), so a serving loop
stays asynchronous:

- deterministic mode (``Config.sample_deterministic``): the first N in-band
  pixels in ascending flat order, by cumulative-sum ranks scattered into N
  slots -- exactly JAX's ``lax.top_k`` over 0/1 priorities;
- random mode: uniform priorities from a ``torch.Generator`` on the depth's
  device, +2 on in-band pixels, and an exact top-N.  JAX takes
  ``lax.approx_max_k`` there, so the two agree in distribution only: both
  give a uniform random subset in random order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Z_MIN, Z_MAX = 0.2, 2.5
BAND = 0.08
MIN_PIXELS = 10


def _first_in_band(sel: torch.Tensor, num_points: int) -> torch.Tensor:
    """(..., P) bool -> (..., num_points) int64: the indices of the first
    num_points True entries in ascending order; slots past the count keep 0
    (only the count's prefix is ever read)."""
    rank = torch.cumsum(sel, dim=-1) - 1
    slot = torch.where(sel & (rank < num_points), rank, num_points)
    order = torch.zeros((*sel.shape[:-1], num_points + 1), dtype=torch.int64,
                        device=sel.device)
    pix = torch.arange(sel.shape[-1], device=sel.device).expand_as(slot)
    # every pixel that is not among the first num_points lands in the
    # extra slot, which is dropped
    return order.scatter_(-1, slot, pix)[..., :num_points]


def choose_hands(depth_masked: torch.Tensor, num_points: int,
                 min_pixels: int = MIN_PIXELS, deterministic: bool = False,
                 generator: Optional[torch.Generator] = None):
    """``_choose_one_hand`` (``pointcloud.py:29-107``) for every hand at once:
    depth_masked (..., P) -> (choose (..., N) int64 flat pixel indices, zero
    where not ok; z (..., N) the masked depth at them; ok (...) bool)."""
    z = depth_masked
    nonzero = z != 0.0
    n_nonzero = nonzero.sum(-1)
    mean = torch.where(n_nonzero > 0,
                       torch.sum(z * nonzero, dim=-1)
                       / torch.clamp(n_nonzero, min=1), 0.0)
    lo = torch.clamp(mean - BAND, min=Z_MIN)[..., None]
    hi = torch.clamp(mean + BAND, max=Z_MAX)[..., None]
    sel = (z > lo) & (z < hi)
    n_valid = sel.sum(-1)
    if deterministic:
        order = _first_in_band(sel, num_points)
        n_eff = n_valid
    else:
        u = torch.rand(z.shape, generator=generator, device=z.device)
        vals, order = torch.topk(u + sel.float() * 2.0, num_points, dim=-1)
        n_eff = (vals > 2.0).sum(-1)
    pos = torch.arange(num_points, device=z.device)
    n_eff = n_eff[..., None]
    wrapped = torch.where(pos < n_eff, pos, pos % torch.clamp(n_eff, min=1))
    choose = torch.gather(order, -1, wrapped)
    z = torch.gather(depth_masked, -1, choose)
    ok = n_valid >= min_pixels
    return torch.where(ok[..., None], choose, 0), z, ok


def backproject_at(choose: torch.Tensor, z: torch.Tensor,
                   K_inv: torch.Tensor, W: int) -> torch.Tensor:
    """``_backproject_at`` (``pointcloud.py:110-123``): flat pixel indices
    (..., N) and their depths -> (..., N, 3) xyz = (K^-1 [u, v, 1]) * z, with
    K_inv (..., 3, 3) per hand."""
    u = (choose % W).float()
    v = torch.div(choose, W, rounding_mode="floor").float()
    rays = (K_inv[..., None, :, 0] * u[..., None]
            + K_inv[..., None, :, 1] * v[..., None]) + K_inv[..., None, :, 2]
    return rays * z[..., None]


def depth_to_hand_clouds(depth: torch.Tensor, mask: torch.Tensor,
                         K: torch.Tensor, valid: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         num_points: int = 1024, with_normals: bool = False,
                         min_pixels: int = MIN_PIXELS,
                         fps_levels: Optional[Tuple[int, int]] = None,
                         deterministic: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """depth (B, H, W) metric, mask (B, H, W, 2) per-hand masks [left, right]
    (probabilities, thresholded at 0.5), K (B, 3, 3), valid (B, 2) -> (choose
    (B, 2, N) int64, cloud (B, 2, N, 3) float32, ok (B, 2) bool), as
    ``depth_to_hand_clouds`` (``pointcloud.py:126-185``).  ``generator``
    feeds the random mode (a fresh one seeded 0 when None, as JAX falls back
    to ``PRNGKey(0)``)."""
    if with_normals:
        raise NotImplementedError("with_normals (input_feature_num=6): the "
                                  "port builds xyz clouds only")
    if fps_levels is not None:
        raise NotImplementedError("fps_levels (sample_strategy='FPS'): the "
                                  "port has no FPS ordering yet")
    B, H, W = depth.shape
    depth = depth.float()
    band = (depth > Z_MIN) & (depth < Z_MAX)
    depth_b = torch.where(band, depth, 0.0)
    hard = (mask > 0.5).permute(0, 3, 1, 2)                  # (B, 2, H, W)
    dm = torch.where(hard, depth_b[:, None], 0.0).reshape(B, 2, H * W)
    if generator is None and not deterministic:
        generator = torch.Generator(device=depth.device).manual_seed(0)
    choose, z, ok = choose_hands(dm, num_points, min_pixels, deterministic,
                                 generator)
    K_inv = torch.linalg.inv_ex(K.float())[0]                # no host sync
    cloud = backproject_at(choose, z, K_inv[:, None], W)
    ok = ok & (valid > 0)
    choose = torch.where(ok[..., None], choose, 0)
    cloud = torch.where(ok[..., None, None], cloud, 0.0)
    return choose, cloud, ok
