"""The port's modules against the JAX package's at float32, with the same
seeded random weights carried across by ``pdfnet_tpu_torch.convert``.

Tolerance ``atol=rtol=1e-4`` on feature maps: the frameworks sum each
convolution in another order (~1e-6 relative per layer) through up to 50
layers of the ResNet; the largest differences seen are ~1e-5.  Projected
pixel coordinates take the absolute part relative to their magnitude (see
``_close_scaled``).  Indices (decoded hand centers) must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.models.encoder import FPNEncoder as JaxFPNEncoder
from pdfnet_tpu.models.encoder import MidFusion as JaxMidFusion
from pdfnet_tpu.models.gcn_decoder import MeshDecoder as JaxMeshDecoder
from pdfnet_tpu.models.resnet import ResNet as JaxResNet
from pdfnet_tpu.ops import grouping

from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.models.encoder import FPNEncoder, MidFusion
from pdfnet_tpu_torch.models.gcn_decoder import MeshDecoder
from pdfnet_tpu_torch.models.resnet import ResNet

from test_torch_eval_step import _random_like
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _variables(module, *args, seed=0):
    """Seeded random flax variables for ``module.init(*args)``."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, *args))
    rng = np.random.RandomState(seed)
    return {c: _random_like(shapes[c], rng) for c in shapes}


def _port(module, variables):
    module.load_state_dict(convert.from_flax(variables, module))
    return module.eval()


def _close_scaled(got, ref):
    """``TOL`` with the absolute part scaled by the array's magnitude: a
    projection ``s * x + t`` of random weights reaches ~1e3 pixels, and
    where its terms cancel the float32 error is relative to the terms."""
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=TOL["atol"] * scale,
                               rtol=TOL["rtol"])


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_convert_refuses_unknown_and_missing_leaves():
    jmod = JaxResNet(stage_sizes=(1, 1, 1, 1), dtype=jnp.float32)
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = _variables(jmod, x, False)
    tmod = ResNet(stage_sizes=(1, 1, 1, 1))
    convert.from_flax(variables, tmod)          # complete: accepted
    extra = {"params": {**variables["params"], "ghost": {"kernel": np.zeros(3)}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="no counterpart"):
        convert.from_flax(extra, tmod)
    short = {"params": variables["params"],
             "batch_stats": {k: v for k, v in variables["batch_stats"].items()
                             if k != "bn1"}}
    with pytest.raises(ValueError, match="not set"):
        convert.from_flax(short, tmod)


def test_resnet50_matches_jax():
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jmod = JaxResNet(dtype=jnp.float32)
    variables = _variables(jmod, x[:1], False, seed=2)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, False))(variables, x)
    tmod = _port(ResNet(), variables)
    with torch.inference_mode():
        got = tmod(_nchw(x))
    assert len(got) == len(ref) == 5             # stem, layer1..layer4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)


def test_fpn_encoder_matches_jax(monkeypatch):
    """FPNEncoder in ``mode="full"``: heads, decoded centers, hms/mask
    decoders, trunk pyramids and the fused point feature."""
    monkeypatch.setattr(grouping, "_FUSED_INTERPRET", True)
    rng = np.random.RandomState(3)
    B, res, n = 2, 64, 256
    img = rng.randn(B, res, res, 3).astype(np.float32)
    cloud = rng.uniform(-0.1, 0.1, (B, 2, n, 3)).astype(np.float32)
    choose = rng.randint(0, res * res, (B, 2, n)).astype(np.int32)
    heads = {"hm": 2, "wh": 2, "params": 122}
    kw = dict(fmap_dim=128, global_feature_dim=256, heatmap_dim=21,
              hand_num=2, resolution=res, knn_k=8, num_level1=128,
              num_level2=128)
    jmod = JaxFPNEncoder(heads=heads, knn_method="pallas_sa",
                         gather_method="take", dtype=jnp.float32, **kw)
    variables = _variables(
        JaxFPNEncoder(heads=heads, knn_method="topk", gather_method="take",
                      dtype=jnp.float32, **kw),
        img[:1], cloud[:1], choose[:1], None, False, seed=4)
    (hms, mask, ret, ind, img_fmaps, hms_fmaps, dp_fmaps,
     _pw) = jax.jit(lambda v, i, c, ch: jmod.apply(v, i, c, ch, None, False)
                    )(variables, img, cloud, choose)

    tmod = _port(FPNEncoder(heads, **kw), variables)
    with torch.inference_mode():
        (t_hms, t_mask, t_ret, t_ind, t_img, t_hmsf, t_dpf) = tmod(
            _nchw(img), torch.from_numpy(cloud), torch.from_numpy(choose))
    np.testing.assert_array_equal(t_ind.numpy(), np.asarray(ind))
    np.testing.assert_allclose(_nhwc(t_hms), np.asarray(hms), **TOL)
    np.testing.assert_allclose(_nhwc(t_mask), np.asarray(mask), **TOL)
    assert sorted(t_ret) == sorted(ret)
    for h in ret:
        np.testing.assert_allclose(_nhwc(t_ret[h]), np.asarray(ret[h]), **TOL)
    np.testing.assert_allclose(t_img[0].numpy(), np.asarray(img_fmaps[0]),
                               **TOL)
    for g, r in zip(t_img[1:] + t_hmsf + t_dpf,
                    list(img_fmaps[1:]) + list(hms_fmaps) + list(dp_fmaps)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)


def test_mid_fusion_matches_jax():
    rng = np.random.RandomState(5)
    B = 2
    sizes, img_c = (2, 4, 8, 16), (None, 32, 16, 8)
    img_fmaps = [rng.randn(B, 2, 1024).astype(np.float32)] + [
        rng.randn(B, s, s, c).astype(np.float32)
        for s, c in zip(sizes[1:], img_c[1:])]
    hms_f = [rng.randn(B, s, s, 8).astype(np.float32) for s in sizes]
    dp_f = [rng.randn(B, s, s, 8).astype(np.float32) for s in sizes]
    out_dims = (8, 8, 8, 8)
    jmod = JaxMidFusion(out_dims=out_dims, dtype=jnp.float32)
    variables = _variables(jmod, img_fmaps, hms_f, dp_f, False, seed=6)
    gl, gr, fmaps = jmod.apply(variables, img_fmaps, hms_f, dp_f, False)
    tmod = _port(MidFusion((16, 48, 32, 24), out_dims), variables)
    with torch.inference_mode():
        t_gl, t_gr, t_fmaps = tmod(
            [torch.from_numpy(img_fmaps[0])] + [_nchw(a) for a in img_fmaps[1:]],
            [_nchw(a) for a in hms_f], [_nchw(a) for a in dp_f])
    np.testing.assert_array_equal(t_gl.numpy(), np.asarray(gl))
    np.testing.assert_array_equal(t_gr.numpy(), np.asarray(gr))
    for g, r in zip(t_fmaps, fmaps):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)


def test_mesh_decoder_matches_jax():
    """Dual-hand GCN decoder (stacked-hands eval form on the JAX side)."""
    rng = np.random.RandomState(7)
    B = 2
    gf_l = rng.randn(B, 1024).astype(np.float32)
    gf_r = rng.randn(B, 1024).astype(np.float32)
    fmaps = [None, None, None]           # read only by ImgAttn, which is off
    jmod = JaxMeshDecoder(stack_hands=True)
    variables = _variables(jmod, gf_l, gf_r, fmaps, False, seed=8)
    result, params, hand_dicts, other = jax.jit(
        lambda v, a, b: jmod.apply(v, a, b, fmaps, False))(variables, gf_l, gf_r)
    tmod = _port(MeshDecoder(), variables)
    with torch.inference_mode():
        t_res, t_par, t_hd, t_oth = tmod(torch.from_numpy(gf_l),
                                         torch.from_numpy(gf_r))
    for side in ("left", "right"):
        for d, td in ((result["verts3d"], t_res["verts3d"]),
                      (result["verts2d"], t_res["verts2d"]),
                      (params["scale"], t_par["scale"]),
                      (params["trans2d"], t_par["trans2d"]),
                      (params["root"], t_par["root"]),
                      (hand_dicts[0]["verts3d"], t_hd[0]["verts3d"]),
                      (hand_dicts[0]["verts2d"], t_hd[0]["verts2d"])):
            _close_scaled(td[side].numpy(), np.asarray(d[side]))
        for key in ("verts3d_MANO_list", "verts2d_MANO_list"):
            _close_scaled(t_oth[key][side][0].numpy(),
                          np.asarray(other[key][side][0]))
