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

``with_normals`` appends each point's surface normal, fitted on the hand's
masked depth (``normals_at``: the plane fit of ``ops.geometry`` at the
chosen pixels only, where JAX fits the whole map and gathers); ``fps_levels``
reorders each hand's cloud and pixel indices by two-level FPS
(``ops.fps``), all hands in one loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pdfnet_tpu_torch.ops.fps import fps_two_level_order
from pdfnet_tpu_torch.ops.geometry import NORMAL_OFFSETS, plane_normals

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


def neighbourhoods(depth: torch.Tensor, choose: torch.Tensor,
                   K_inv: torch.Tensor) -> torch.Tensor:
    """The plane fit's neighbourhoods at flat pixel indices choose (..., N)
    of depth maps (..., H, W) with K_inv (..., 3, 3): (..., N, 25, 3) the
    backprojected points at the ``NORMAL_OFFSETS`` grid around each pixel,
    zero outside the map (``depth_normals``' zero padding)."""
    H, W = depth.shape[-2:]
    u, v = choose % W, torch.div(choose, W, rounding_mode="floor")
    # the offsets made on the device: a host list would copy and synchronise
    n = len(NORMAL_OFFSETS)
    offs = torch.arange(n, device=choose.device) * 2 - 4
    dy, dx = offs[:, None].expand(n, n).reshape(-1), offs.repeat(n)
    uu, vv = u[..., None] + dx, v[..., None] + dy            # (..., N, 25)
    inside = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
    pix = torch.where(inside, vv * W + uu, 0)
    flat = depth.reshape(*depth.shape[:-2], 1, H * W)
    z = torch.gather(flat.expand(*pix.shape[:-1], H * W), -1, pix)
    return backproject_at(pix, torch.where(inside, z, 0.0),
                          K_inv[..., None, :, :], W)


def normals_at(depth: torch.Tensor, choose: torch.Tensor,
               K_inv: torch.Tensor) -> torch.Tensor:
    """Unit normals (..., N, 3) at flat pixel indices choose (..., N) of
    depth maps (..., H, W): ``depth_normals`` of ``backproject_depth(depth,
    K_inv)`` gathered at choose, computed at the chosen pixels only."""
    return plane_normals(neighbourhoods(depth, choose, K_inv))


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
    (B, 2, N) int64, cloud (B, 2, N, 3 or 6) float32, ok (B, 2) bool), as
    ``depth_to_hand_clouds`` (``pointcloud.py:126-185``).  ``generator``
    feeds the random mode (a fresh one seeded 0 when None, as JAX falls back
    to ``PRNGKey(0)``).  ``with_normals`` appends the normals of each hand's
    masked depth; ``fps_levels=(n1, n2)`` then reorders each hand by
    two-level FPS, before the hands that are not valid are zeroed."""
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
    cloud = torch.where(ok[..., None, None],
                        backproject_at(choose, z, K_inv[:, None], W), 0.0)
    if with_normals:
        nrm = normals_at(dm.reshape(B, 2, H, W), choose, K_inv[:, None])
        cloud = torch.cat([cloud, torch.where(ok[..., None, None], nrm, 0.0)],
                          dim=-1)
    if fps_levels is not None:
        order = fps_two_level_order(cloud[..., :3], *fps_levels)
        choose = torch.gather(choose, -1, order)
        cloud = torch.gather(cloud, 2, order[..., None].expand_as(cloud))
    ok = ok & (valid > 0)
    choose = torch.where(ok[..., None], choose, 0)
    cloud = torch.where(ok[..., None, None], cloud, 0.0)
    return choose, cloud, ok
