"""Farthest point sampling on the device (port of ``pdfnet_tpu/ops/fps.py``;
``--sample_strategy FPS`` on the self-contained path).

Every function takes a batch of hands (..., N, 3) and runs all of them in
one loop of ``num_samples - 1`` dependent steps: an argmax, a gather and a
distance update a step, with no host synchronisation.  The JAX package has
no Pallas kernel here (a ``lax.fori_loop``), so neither has the port.

The squared distance is ``(dx*dx + dy*dy) + dz*dz`` in float32, the same
bits on the card and on the CPU, and ``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does: wrap-padded clouds repeat points, so ties
are common once the farthest distances reach zero.
"""

from __future__ import annotations

import torch


def _sqdist(points: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(H, N, 3), (H, 3) -> (H, N) squared distances to p."""
    d = points - p[:, None, :]
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def farthest_point_sampling(points: torch.Tensor, num_samples: int,
                            first_idx: int = 0) -> torch.Tensor:
    """Greedy FPS over (..., N, 3) points from ``first_idx`` ->
    (..., num_samples) int64 indices in pick order."""
    lead, N = points.shape[:-2], points.shape[-2]
    pts = points.reshape(-1, N, 3).float()
    rows = torch.arange(pts.shape[0], device=pts.device)
    picks = [torch.full((pts.shape[0],), first_idx, dtype=torch.int64,
                        device=pts.device)]
    min_dist = _sqdist(pts, pts[:, first_idx])
    for _ in range(1, num_samples):
        nxt = torch.argmax(min_dist, dim=-1)
        picks.append(nxt)
        min_dist = torch.minimum(min_dist, _sqdist(pts, pts[rows, nxt]))
    return torch.stack(picks, dim=-1).reshape(*lead, num_samples)


def _fps_prefix_order(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(H, N, 3) -> (H, N) permutations of range(N): the FPS picks first, in
    ascending index order, then the rest.  A re-picked index (coincident
    points) leaves its slot to the remainder, so each row is a full
    permutation."""
    idx = farthest_point_sampling(xyz, num_samples)
    picked = torch.zeros(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    picked.scatter_(1, idx, True)
    return torch.argsort((~picked).int(), dim=-1, stable=True)


def fps_two_level_order(points_xyz: torch.Tensor, num_level1: int,
                        num_level2: int) -> torch.Tensor:
    """(..., N, 3) -> (..., N) permutations putting two-level FPS picks in
    the prefix: level-1 centers first among all points, level-2 centers
    first within the level-1 prefix."""
    lead, N = points_xyz.shape[:-2], points_xyz.shape[-2]
    xyz = points_xyz.reshape(-1, N, 3)
    order1 = _fps_prefix_order(xyz, num_level1)
    head1 = order1[:, :num_level1]
    pts1 = torch.gather(xyz, 1, head1[..., None].expand(-1, -1, 3))
    head = torch.gather(head1, 1, _fps_prefix_order(pts1, num_level2))
    return torch.cat([head, order1[:, num_level1:]], dim=-1).reshape(*lead, N)


def fps_reorder(points: torch.Tensor, num_level1: int,
                num_level2: int) -> torch.Tensor:
    """Reorder (..., N, C) points, xyz leading, so that the FPS picks take
    the prefix (``fps_two_level_order`` gives the permutation itself, for
    companion arrays such as pixel indices)."""
    order = fps_two_level_order(points[..., :3], num_level1, num_level2)
    idx = order[..., None].expand(*order.shape, points.shape[-1])
    return torch.gather(points, -2, idx)
