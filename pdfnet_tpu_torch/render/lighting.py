"""Spherical-harmonics illumination (port of
``pdfnet_tpu/render/lighting.py``; the photometric-loss texture path).

Reference: ManoRender.Illumination_layer + set_Illu_consts
(Mano_render.py:286-335): 9-band SH lighting of per-vertex albedo given
per-vertex normals and a 27-dim (3x9) lighting code.
"""

from __future__ import annotations

import numpy as np
import torch

_A0 = np.pi
_A1 = 2 * np.pi / np.sqrt(3.0)
_A2 = 2 * np.pi / np.sqrt(8.0)
_C0 = 1 / np.sqrt(4 * np.pi)
_C1 = np.sqrt(3.0) / np.sqrt(4 * np.pi)
_C2 = 3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)
_D0 = 0.5 / np.sqrt(3.0)


def sh_basis(normals: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit normals -> (..., 9) SH basis values."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    ones = torch.ones_like(nx)
    return torch.stack([
        ones * (_A0 * _C0),
        -_A1 * _C1 * ny,
        _A1 * _C1 * nz,
        -_A1 * _C1 * nx,
        _A2 * _C2 * nx * ny,
        -_A2 * _C2 * ny * nz,
        _A2 * _C2 * _D0 * (3 * nz ** 2 - 1),
        -_A2 * _C2 * nx * nz,
        _A2 * _C2 * 0.5 * (nx ** 2 - ny ** 2),
    ], dim=-1)


def sh_illumination(albedo: torch.Tensor, normals: torch.Tensor,
                    gamma: torch.Tensor):
    """Shade per-vertex albedo with SH lighting.

    Args:
      albedo: (B, V, 3) per-vertex color.
      normals: (B, V, 3) unit normals.
      gamma: (B, 27) lighting code; reshaped (3, 9), DC boosted by +0.8.

    Returns: (face_color (B, V, 3), lighting (B, V, 3)).
    """
    g = gamma.reshape(-1, 3, 9).clone()
    g[:, :, 0] += 0.8
    Y = sh_basis(normals)                                  # (B, V, 9)
    lighting = torch.einsum("bvn,bcn->bvc", Y, g)          # (B, V, 3)
    return albedo * lighting, lighting
