"""Triangle rasterizer of the two hand meshes (port of
``pdfnet_tpu/render/rasterizer.py``; the reference renders with pytorch3d).

Covers the reference's rendering needs (mano_utils.py:44-207
mano_two_hands_renderer, RenderDepthRgbMask.py): z-buffered RGB / mask /
depth of the two-hand mesh under a pinhole camera, with per-vertex colors
and diffuse shading, for the demo's overlays.

Edge-function coverage of every pixel center, the faces taken in chunks of
``face_chunk`` with a running z-buffer, exactly as the JAX function's
``lax.scan`` does: within a chunk the lowest face index wins a z tie (as
``jnp.argmin`` picks it; found here by an index-min, since
``torch.argmin`` states no order among equal values), across chunks the
earlier chunk wins (the buffer takes a strictly nearer z).  Each chunk's
temporaries are (face_chunk, H*W): 75 MB of float32 apiece at 384x384.
Runs on the device of its inputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _edge(a, b, p):
    """Signed area of (a, b, p); (C, 1, 2) against (P, 2) broadcasts to
    (C, P)."""
    return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) -
            (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))


def rasterize_mesh(verts2d: torch.Tensor, z: torch.Tensor,
                   faces: torch.Tensor, height: int = 384, width: int = 384,
                   face_chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """verts2d (V, 2) pixel coordinates, z (V,) camera-space depth (> 0),
    faces (F, 3) integer.  Returns (zbuf (H, W), face_id (H, W) int32, -1
    where no face covers the pixel, bary (H, W, 3)); zbuf is 0 there."""
    dev = verts2d.device
    faces = faces.to(device=dev, dtype=torch.long)
    F = faces.shape[0]
    pad = (-F) % face_chunk
    faces_p = torch.cat([faces, faces.new_zeros((pad, 3))])
    fxy, fz = verts2d[faces_p], z[faces_p]             # (Fp, 3, 2), (Fp, 3)
    valid_face = torch.arange(F + pad, device=dev) < F

    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")     # (H, W)
    pix = torch.stack([px, py], -1).reshape(-1, 2)      # (P, 2)
    P = pix.shape[0]

    zbuf = torch.full((P,), float("inf"), device=dev)
    fid_buf = torch.full((P,), -1, dtype=torch.int32, device=dev)
    bary_buf = torch.zeros((P, 3), device=dev)
    rows = torch.arange(face_chunk, device=dev)[:, None]
    for start in range(0, F + pad, face_chunk):
        sl = slice(start, start + face_chunk)
        cxy, cz, cvalid = fxy[sl], fz[sl], valid_face[sl]
        a, b, c = cxy[:, None, 0], cxy[:, None, 1], cxy[:, None, 2]
        w0 = _edge(b, c, pix)                           # (C, P)
        w1 = _edge(c, a, pix)
        w2 = _edge(a, b, pix)
        area = _edge(a, b, c)                           # (C, 1)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) |
                  ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
        denom = torch.where(area.abs() < 1e-9, torch.ones_like(area), area)
        zi = (w0 / denom * cz[:, 0:1] + w1 / denom * cz[:, 1:2] +
              w2 / denom * cz[:, 2:3])                  # (C, P)
        ok = inside & cvalid[:, None] & (area.abs() > 1e-9) & (zi > 0)
        zi = torch.where(ok, zi, torch.full_like(zi, float("inf")))
        best_z = zi.amin(dim=0)                         # (P,)
        # the lowest row holding the minimum, as jnp.argmin picks it
        best = torch.where(zi == best_z, rows, face_chunk).amin(dim=0)
        hit = best_z < zbuf
        zbuf = torch.where(hit, best_z, zbuf)
        fid_buf = torch.where(hit, (best + start).to(torch.int32), fid_buf)
        sel = lambda w: (w.gather(0, best[None]) /
                         denom[:, 0].gather(0, best))[0]
        new_bary = torch.stack([sel(w0), sel(w1), sel(w2)], -1)
        bary_buf = torch.where(hit[:, None], new_bary, bary_buf)
    zbuf = torch.where(torch.isinf(zbuf), torch.zeros_like(zbuf), zbuf)
    return (zbuf.reshape(height, width), fid_buf.reshape(height, width),
            bary_buf.reshape(height, width, 3))


def shade_vertex_colors(fid: torch.Tensor, bary: torch.Tensor,
                        faces: torch.Tensor,
                        vert_colors: torch.Tensor) -> torch.Tensor:
    """Interpolate per-vertex colors (V, C) at rasterized pixels; 0 where
    no face hits."""
    faces = faces.to(device=fid.device, dtype=torch.long)
    tri = faces[fid.clamp_min(0).long()]                 # (H, W, 3)
    cols = vert_colors[tri]                              # (H, W, 3, C)
    rgb = torch.einsum("hwk,hwkc->hwc", bary, cols)
    return torch.where((fid >= 0)[..., None], rgb, torch.zeros_like(rgb))


SKIN_COLOR = np.array([0.85, 0.68, 0.58], np.float32)


def render_two_hands(verts_left: torch.Tensor, verts_right: torch.Tensor,
                     K: torch.Tensor, faces_left: np.ndarray,
                     faces_right: np.ndarray, height: int = 384,
                     width: int = 384):
    """Render both hands (778, 3) each in camera space under K (3, 3) in
    SKIN_COLOR, lit from (0, 0, 1): returns (rgb (H, W, 3), mask (H, W),
    depth (H, W)) on the vertices' device.

    Equivalent of mano_two_hands_renderer.render_rgb: meshes concatenated
    with the right-hand face indices offset by 778 and the left-hand faces
    re-wound so both meshes are front-facing.
    """
    dev = verts_left.device
    verts = torch.cat([verts_left, verts_right], dim=0)          # (1556, 3)
    faces = torch.from_numpy(np.concatenate(
        [faces_left[:, ::-1], faces_right + 778]).astype(np.int64)).to(dev)

    proj = verts @ K.to(verts).T
    v2d = proj[:, :2] / (proj[:, 2:] + 1e-8)
    zbuf, fid, bary = rasterize_mesh(v2d, verts[:, 2], faces, height, width)

    # per-vertex normals for diffuse shading
    fn = torch.linalg.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                            verts[faces[:, 2]] - verts[faces[:, 1]])
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k], fn)
    vn = vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-8)
    diffuse = vn[:, 2:].abs().clamp(0.2, 1.0)      # light along +z

    vert_colors = torch.from_numpy(SKIN_COLOR).to(verts).expand_as(verts)
    rgb = shade_vertex_colors(fid, bary, faces, vert_colors * diffuse)
    mask = (fid >= 0).to(torch.float32)
    return rgb, mask, zbuf
