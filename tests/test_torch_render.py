"""The port's renderer (``pdfnet_tpu_torch.render``) against the JAX
package's on the same inputs: the rasterizer on planted cases (one
triangle, depth order, exact z ties inside a face chunk and across chunks,
degenerate and behind-camera faces, a padded last chunk) and on the two
MANO hands from the port's MANO, the vertex-color shading, the two-hand
render, and the SH lighting.

Tolerances: ``fid`` and the mask are required equal; zbuf, barycentrics,
rgb and depth within 1e-5 (the two frameworks sum the projected
coordinates and the scatter-added normals in other orders, float32
rounding of ~1e-7 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.render import lighting as jax_light
from pdfnet_tpu.render import rasterizer as jax_rast

from pdfnet_tpu_torch import assets
from pdfnet_tpu_torch.mano import layer as mano
from pdfnet_tpu_torch.render import lighting, rasterizer
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
TRI = [[8.0, 4.0], [56.0, 4.0], [32.0, 56.0]]


def _both_raster(v2d, z, faces, h=64, w=64, face_chunk=128):
    v2d = np.asarray(v2d, np.float32)
    z = np.asarray(z, np.float32)
    faces = np.asarray(faces, np.int32)
    ref = jax_rast.rasterize_mesh(jnp.asarray(v2d), jnp.asarray(z),
                                  jnp.asarray(faces), h, w, face_chunk)
    got = rasterizer.rasterize_mesh(torch.from_numpy(v2d),
                                    torch.from_numpy(z),
                                    torch.from_numpy(faces), h, w,
                                    face_chunk)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_raster_equal(ref, got):
    (zr, fr, br), (zg, fg, bg) = ref, got
    assert fg.dtype == np.int32 and fg.shape == fr.shape
    np.testing.assert_array_equal(fg, fr)
    np.testing.assert_allclose(zg, zr, **TOL)
    np.testing.assert_allclose(bg, br, **TOL)


def test_single_triangle():
    ref, got = _both_raster(TRI, [0.5] * 3, [[0, 1, 2]])
    _assert_raster_equal(ref, got)
    zbuf, fid, _ = got
    assert fid[30, 32] == 0 and abs(zbuf[30, 32] - 0.5) < 1e-6
    assert fid[2, 2] == -1 and zbuf[2, 2] == 0.0


@pytest.mark.parametrize("order", [(0.9, 0.4), (0.4, 0.9)])
def test_depth_order(order):
    """The nearer of two stacked triangles wins, whichever comes first."""
    za, zb = order
    ref, got = _both_raster(TRI * 2, [za] * 3 + [zb] * 3,
                            [[0, 1, 2], [3, 4, 5]])
    _assert_raster_equal(ref, got)
    assert got[1][30, 32] == (1 if zb < za else 0)


@pytest.mark.parametrize("face_chunk,want", [
    (8, 1),      # ties at faces 1, 2, 3 in one chunk: the lowest index
    (2, 1),      # faces 1 | 2, 3: the earlier chunk keeps its face
    (3, 1),      # faces 1, 2 | 3
    (1, 1)])     # every face its own chunk
def test_exact_z_ties(face_chunk, want):
    """Faces 1-3 are the same triangle at the same depth (an exact tie),
    face 0 lies behind them and face 4 is a wound-backwards copy behind
    too: within a chunk the lowest face index wins, as ``jnp.argmin``
    picks it, and across chunks the earlier chunk wins (strict <)."""
    v2d = TRI * 5
    z = [0.9] * 3 + [0.5] * 9 + [0.7] * 3
    faces = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11], [14, 13, 12]]
    ref, got = _both_raster(v2d, z, faces, face_chunk=face_chunk)
    _assert_raster_equal(ref, got)
    inside = got[1] >= 0
    assert inside.sum() > 500 and (got[1][inside] == want).all()


def test_tie_winner_is_not_the_chunk_start():
    """In a chunk [far, near, near copy] the tie goes to face 1."""
    v2d = TRI * 3
    z = [0.9] * 3 + [0.5] * 6
    ref, got = _both_raster(v2d, z, [[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    _assert_raster_equal(ref, got)
    assert (got[1][got[1] >= 0] == 1).all()


def test_degenerate_and_behind_camera_faces():
    """A zero-area face and a face at negative depth never cover a pixel,
    a wound-backwards face behind face 0 loses to it, and 5 faces in
    chunks of 2 pad the last chunk with masked faces."""
    v2d = TRI + [[10.0, 10.0], [20.0, 20.0], [30.0, 30.0]] + TRI + TRI
    z = [0.6] * 3 + [0.3] * 3 + [-0.2] * 3 + [0.8] * 3
    faces = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [11, 10, 9], [3, 4, 5]]
    ref, got = _both_raster(v2d, z, faces, face_chunk=2)
    _assert_raster_equal(ref, got)
    assert set(np.unique(got[1])) == {-1, 0}


def _mano_hands(seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)[None])
    out = []
    for side, x in (("left", -0.05), ("right", 0.05)):
        c = mano.load_mano_consts(side, device="cpu")
        v, _ = mano.mano_forward(c, t(rng.uniform(-0.3, 0.3, 3)),
                                 t(rng.uniform(-0.5, 0.5, 45)),
                                 t(rng.uniform(-1, 1, 10)),
                                 trans=t([x, rng.uniform(-0.01, 0.01), 0.5]))
        out.append(v[0].numpy())
    return out


def _K(res):
    return np.array([[1.5 * res, 0, res / 2], [0, 1.5 * res, res / 2],
                     [0, 0, 1]], np.float32)


FACES = (assets.load_mano("left").faces, assets.load_mano("right").faces)


@pytest.mark.parametrize("res,seed", [(64, 0), (96, 1), (128, 2)])
def test_mano_hands_raster(res, seed):
    """Both hands' faces (left re-wound, right offset by 778) under a
    pinhole camera, 3076 faces in 25 chunks."""
    vl, vr = _mano_hands(seed)
    verts = np.concatenate([vl, vr])
    faces = np.concatenate([FACES[0][:, ::-1], FACES[1] + 778])
    proj = verts @ _K(res).T
    v2d = proj[:, :2] / (proj[:, 2:] + 1e-8)
    ref, got = _both_raster(v2d, verts[:, 2], faces, res, res)
    _assert_raster_equal(ref, got)
    assert (got[1] >= 0).sum() > 0.05 * res * res


def test_shade_vertex_colors():
    vl, vr = _mano_hands(3)
    verts = np.concatenate([vl, vr])
    faces = np.concatenate([FACES[0][:, ::-1], FACES[1] + 778]).astype(
        np.int32)
    proj = verts @ _K(64).T
    v2d = proj[:, :2] / (proj[:, 2:] + 1e-8)
    _, (_, fid, bary) = _both_raster(v2d, verts[:, 2], faces)
    cols = np.random.RandomState(0).rand(1556, 3).astype(np.float32)
    ref = jax_rast.shade_vertex_colors(jnp.asarray(fid), jnp.asarray(bary),
                                       jnp.asarray(faces), jnp.asarray(cols))
    got = rasterizer.shade_vertex_colors(
        torch.from_numpy(fid), torch.from_numpy(bary),
        torch.from_numpy(faces), torch.from_numpy(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("res", [64, 96, 128])
def test_render_two_hands(res):
    vl, vr = _mano_hands(res)
    ref = jax_rast.render_two_hands(
        jnp.asarray(vl), jnp.asarray(vr), jnp.asarray(_K(res)), *FACES, res,
        res)
    got = rasterizer.render_two_hands(
        torch.from_numpy(vl), torch.from_numpy(vr),
        torch.from_numpy(_K(res)), *FACES, res, res)
    rgb, mask, depth = (np.asarray(r) for r in ref)
    g_rgb, g_mask, g_depth = (g.numpy() for g in got)
    assert g_rgb.shape == (res, res, 3) and g_mask.shape == (res, res)
    np.testing.assert_array_equal(g_mask, mask)
    assert mask.sum() > 0.05 * res * res
    np.testing.assert_allclose(g_rgb, rgb, **TOL)
    np.testing.assert_allclose(g_depth, depth, **TOL)


def test_sh_basis_and_illumination():
    rng = np.random.RandomState(0)
    n = rng.randn(2, 50, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    albedo = rng.rand(2, 50, 3).astype(np.float32)
    gamma = (rng.randn(2, 27) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        lighting.sh_basis(torch.from_numpy(n)).numpy(),
        np.asarray(jax_light.sh_basis(jnp.asarray(n))), **TOL)
    ref = jax_light.sh_illumination(jnp.asarray(albedo), jnp.asarray(n),
                                    jnp.asarray(gamma))
    g = torch.from_numpy(gamma)
    got = lighting.sh_illumination(torch.from_numpy(albedo),
                                   torch.from_numpy(n), g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the lighting code is not changed in place
    np.testing.assert_array_equal(g.numpy(), gamma)
