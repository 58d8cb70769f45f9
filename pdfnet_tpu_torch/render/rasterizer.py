"""Triangle rasterizer of the two hand meshes (port of
``pdfnet_tpu/render/rasterizer.py``; the reference renders with pytorch3d).

Covers the reference's rendering needs (mano_utils.py:44-207
mano_two_hands_renderer, RenderDepthRgbMask.py): z-buffered RGB / mask /
depth of the two-hand mesh under a pinhole camera, with per-vertex colors
and diffuse shading, for the demo's overlays and the photometric loss.

Edge-function coverage of every pixel center, the faces taken in chunks of
``face_chunk`` with a running z-buffer, exactly as the JAX function's
``lax.scan`` does: within a chunk the lowest face index wins a z tie (as
``jnp.argmin`` picks it; found here by an index-min, since
``torch.argmin`` states no order among equal values), across chunks the
earlier chunk wins (the buffer takes a strictly nearer z).  Each chunk's
temporaries are (face_chunk, pixels of its faces' box): up to 75 MB of
float32 apiece at 384x384, held without gradients and freed chunk by
chunk; what the backward keeps is (H*W,) per quantity
(``rasterize_mesh``).  Runs on the device of its inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _edge(a, b, p):
    """Signed area of (a, b, p); (C, 1, 2) against (P, 2) broadcasts to
    (C, P)."""
    return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) -
            (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))


def _face_stats(a, b, c, pix, cz):
    """Edge functions, barycentrics and interpolated z of faces with corners
    a, b, c (..., 2) and corner depths cz (..., 3) at the pixel centers
    ``pix``; every caller broadcasts the same expressions, so a value
    computed for one (face, pixel) pair is the same bits in either form."""
    w0 = _edge(b, c, pix)
    w1 = _edge(c, a, pix)
    w2 = _edge(a, b, pix)
    area = _edge(a, b, c)
    denom = torch.where(area.abs() < 1e-9, torch.ones_like(area), area)
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    zi = b0 * cz[..., 0] + b1 * cz[..., 1] + b2 * cz[..., 2]
    return (w0, w1, w2), area, (b0, b1, b2), zi


def _pixel_centers(y0: int, y1: int, x0: int, x1: int, dev) -> torch.Tensor:
    """(x, y) centers of the pixels of rows y0:y1, columns x0:x1, row-major
    ((y1 - y0) * (x1 - x0), 2)."""
    ys = torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(x0, x1, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([px, py], -1).reshape(-1, 2)


@torch.no_grad()
def _depth_test(fxy: torch.Tensor, fz: torch.Tensor, n_faces: int,
                height: int, width: int, face_chunk: int) -> torch.Tensor:
    """The winning face of every pixel (H*W,) int64, -1 where none covers
    it: the z-buffer over chunks of ``face_chunk`` faces, without gradients.

    Each chunk is tested on the pixels of its faces' bounding box grown by
    2 pixels (clipped to the image; the whole image if a coordinate is not
    finite): a pixel farther out is outside every face of the chunk by far
    more than float32 rounding of the edge functions, so it would not take
    the chunk's face, and the result is the whole-image test's.  The boxes
    reach the host in one copy."""
    dev = fxy.device
    zbuf = torch.full((height, width), float("inf"), device=dev)
    fid = torch.full((height, width), -1, dtype=torch.long, device=dev)
    rows = torch.arange(face_chunk, device=dev)[:, None]
    chunks = fxy.reshape(-1, face_chunk * 3, 2)
    inf = float("inf")
    lo = chunks.amin(1).nan_to_num(-inf, -inf, -inf)          # (n, 2) x, y
    hi = chunks.amax(1).nan_to_num(inf, inf, inf)
    lim = torch.tensor([width, height], dtype=torch.float32, device=dev)
    boxes = torch.cat([(lo - 2).floor().clamp(min=0).minimum(lim),
                       (hi + 2).ceil().clamp(min=0).minimum(lim)], 1)
    for c, (x0, y0, x1, y1) in enumerate(boxes.to(torch.int64).tolist()):
        if x0 >= x1 or y0 >= y1:
            continue
        start = c * face_chunk
        cxy, cz = fxy[start:start + face_chunk], fz[start:start + face_chunk]
        (w0, w1, w2), area, _, zi = _face_stats(
            cxy[:, None, 0], cxy[:, None, 1], cxy[:, None, 2],
            _pixel_centers(y0, y1, x0, x1, dev), cz[:, None])   # (C, p)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) |
                  ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
        real = (start + rows) < n_faces                 # padding faces
        ok = inside & real & (area.abs() > 1e-9) & (zi > 0)
        zi = torch.where(ok, zi, torch.full_like(zi, inf))
        best_z = zi.amin(dim=0)                         # (p,)
        # the lowest row holding the minimum, as jnp.argmin picks it
        best = torch.where(zi == best_z, rows, face_chunk).amin(dim=0)
        zb = zbuf[y0:y1, x0:x1].reshape(-1)
        hit = best_z < zb
        zbuf[y0:y1, x0:x1] = torch.where(hit, best_z, zb).view(y1 - y0,
                                                               x1 - x0)
        fb = fid[y0:y1, x0:x1].reshape(-1)
        fid[y0:y1, x0:x1] = torch.where(hit, best + start, fb).view(
            y1 - y0, x1 - x0)
    return fid.reshape(-1)


def rasterize_mesh(verts2d: torch.Tensor, z: torch.Tensor,
                   faces: torch.Tensor, height: int = 384, width: int = 384,
                   face_chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """verts2d (V, 2) pixel coordinates, z (V,) camera-space depth (> 0),
    faces (F, 3) integer.  Returns (zbuf (H, W), face_id (H, W) int32, -1
    where no face covers the pixel, bary (H, W, 3)); zbuf is 0 there.

    The depth test runs without gradients and keeps only each pixel's
    winning face; the barycentrics and z of that face are then computed
    again at each pixel, with gradients, from the same expressions on the
    same operands, so the forward is the chunked test's bit for bit and the
    backward holds (P,) tensors instead of every chunk's (face_chunk, P)
    ones.  The gradient is the JAX function's: there it flows only through
    the selected face's b0..b2 and z (``take_along_axis`` and ``where``).
    """
    dev = verts2d.device
    faces = faces.to(device=dev, dtype=torch.long)
    F = faces.shape[0]
    pad = (-F) % face_chunk
    faces_p = torch.cat([faces, faces.new_zeros((pad, 3))])
    fxy, fz = verts2d[faces_p], z[faces_p]             # (Fp, 3, 2), (Fp, 3)

    pix = _pixel_centers(0, height, 0, width, dev)      # (P, 2)
    fid = _depth_test(fxy.detach(), fz.detach(), F, height, width,
                      face_chunk)
    hit = fid >= 0
    win = fid.clamp_min(0)
    cxy, cz = fxy[win], fz[win]                         # (P, 3, 2), (P, 3)
    _, _, bary, zi = _face_stats(cxy[:, 0], cxy[:, 1], cxy[:, 2], pix, cz)
    bary = torch.where(hit[:, None], torch.stack(bary, -1),
                       torch.zeros((), device=dev))
    zbuf = torch.where(hit, zi, torch.zeros((), device=dev))
    return (zbuf.reshape(height, width),
            fid.to(torch.int32).reshape(height, width),
            bary.reshape(height, width, 3))


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
                     K: torch.Tensor, faces_left, faces_right,
                     height: int = 384, width: int = 384,
                     vert_colors: Optional[torch.Tensor] = None):
    """Render both hands (778, 3) each in camera space under K (3, 3):
    returns (rgb (H, W, 3), mask (H, W), depth (H, W)) on the vertices'
    device.  Faces are (F, 3) integer arrays or tensors; ``vert_colors``
    (1556, 3), left hand first, default SKIN_COLOR; the colors are lit
    diffusely from (0, 0, 1).  Differentiable in the vertices and the
    colors (the mask is hard: ``fid >= 0``).

    Equivalent of mano_two_hands_renderer.render_rgb: meshes concatenated
    with the right-hand face indices offset by 778 and the left-hand faces
    re-wound so both meshes are front-facing.
    """
    dev = verts_left.device
    verts = torch.cat([verts_left, verts_right], dim=0)          # (1556, 3)
    idx = lambda f: torch.as_tensor(f).to(dev, torch.long)
    faces = torch.cat([idx(faces_left).flip(1), idx(faces_right) + 778])

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

    if vert_colors is None:
        vert_colors = torch.from_numpy(SKIN_COLOR).to(verts).expand_as(verts)
    rgb = shade_vertex_colors(fid, bary, faces, vert_colors * diffuse)
    mask = (fid >= 0).to(torch.float32)
    return rgb, mask, zbuf
