"""The HandNet options of the port that change the model's graph, against
the JAX package with the same seeded weights (``convert.from_flax``), in
float32 on the CPU:

- ``patch_heads``: the non-hm heads on 3x3 patches at the two centers equal
  the full-map heads gathered there (the port alone, centers inside the map
  and on its border, within 1e-5 relative: the same sums, another
  convolution algorithm), and the JAX encoder's patch heads (1e-4, the
  modules' bar of ``test_torch_models.py``);
- ``s2d_stem``: the ResNet-50 against JAX's ``ResNet(s2d_stem=True)`` (1e-4)
  and against the port's own 7x7 stem (2e-5 absolute, 1e-5 relative: the
  JAX package's bar for the same rewrite, ``tests/test_trunk_fused.py``);
- ``use_img_attn``: ``ImgAttn`` and the mesh decoder with it against JAX
  (1e-4, with ``test_torch_models._close_scaled`` for pixel coordinates),
  and the whole eval step with ``patch_heads``, ``s2d_stem`` and
  ``use_img_attn`` together at res 192 (``img_sizes`` 6 / 12 / 24: at res
  64 the image attention has no patch) within ``test_torch_eval_step``'s
  2e-4;
- ``knn_method="approx"``: the selected distances bit for bit against
  ``lax.approx_max_k``'s values, the indices against ``lax.top_k`` of the
  same bf16 values (an exact top-k is a legal result of ``approx_max_k``,
  which on the CPU returns the same values with other indices among bf16
  ties), and the properties of the ball query;
- the exported ops the model does not call: ``gather_feat``,
  ``heatmap_topk`` (ties to the lowest index, as ``lax.top_k``) and
  ``cheb_conv`` (1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import build_model as jax_build_model
from pdfnet_tpu.models.attention import ImgAttn as JaxImgAttn
from pdfnet_tpu.models.encoder import FPNEncoder as JaxFPNEncoder
from pdfnet_tpu.models.gcn_decoder import MeshDecoder as JaxMeshDecoder
from pdfnet_tpu.models.resnet import ResNet as JaxResNet
from pdfnet_tpu.ops import chebconv as jax_cheb
from pdfnet_tpu.ops import gather as jax_gather
from pdfnet_tpu.ops import grouping as jax_grouping
from pdfnet_tpu.ops import heatmap as jax_heatmap
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts
from pdfnet_tpu.train.step import make_eval_step as jax_eval_step

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch import convert, ops
from pdfnet_tpu_torch.models.attention import ImgAttn
from pdfnet_tpu_torch.models.encoder import FPNEncoder
from pdfnet_tpu_torch.models.gcn_decoder import MeshDecoder
from pdfnet_tpu_torch.models.resnet import ResNet
from pdfnet_tpu_torch.ops import grouping
from pdfnet_tpu_torch.ops.gather import gather_pixels

from test_torch_eval_step import TOL as STEP_TOL
from test_torch_eval_step import _batch, jax_variables
from test_torch_models import TOL, _close_scaled, _nchw, _nhwc, _port
from test_torch_models import _variables
from test_torch_train_step import one_torch_thread  # noqa: F401

HEADS = {"hm": 2, "wh": 2, "params": 122, "texture": 2334, "light": 27}
ENC = dict(fmap_dim=128, global_feature_dim=256, heatmap_dim=21, hand_num=2,
           resolution=64, knn_k=8, num_level1=128, num_level2=128)
REL = dict(rtol=1e-5, atol=1e-5)


# ---- patch_heads -------------------------------------------------------------

@pytest.fixture(scope="module")
def encoders():
    """JAX and port encoders with the photometric heads, the same weights,
    and an image."""
    img = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = _variables(
        JaxFPNEncoder(heads=HEADS, knn_method="topk", gather_method="take",
                      dtype=jnp.float32, **ENC),
        img[:1], np.zeros((1, 2, 256, 3), np.float32),
        np.zeros((1, 2, 256), np.int32), None, False, seed=1)
    full = _port(FPNEncoder(HEADS, **ENC), variables)
    patch = _port(FPNEncoder(HEADS, patch_heads=True, **ENC), variables)
    return variables, img, full, patch


@pytest.mark.parametrize("where", ["inside", "border"])
def test_patch_heads_equal_full_heads_at_centers(encoders, where):
    _, img, full, patch = encoders
    ind = (torch.tensor([[40, 200], [17, 130]]) if where == "inside"
           else torch.tensor([[0, 15], [16 * 16 - 1, 16 * 15]]))
    with torch.inference_mode():
        _, _, ret_f, _, _ = full.image_phase(_nchw(img), ind)
        _, _, ret_p, ind_p, _ = patch.image_phase(_nchw(img), ind)
    assert torch.equal(ind_p, ind)
    assert sorted(ret_p) == sorted(ret_f)
    torch.testing.assert_close(ret_p["hm"], ret_f["hm"], rtol=0, atol=0)
    for h in HEADS:
        if h == "hm":
            continue
        assert ret_p[h].shape == (2, 2, HEADS[h])
        want = gather_pixels(ret_f[h].permute(0, 2, 3, 1), ind)
        np.testing.assert_allclose(ret_p[h].numpy(), want.numpy(), **REL,
                                   err_msg=h)


def test_patch_heads_match_jax(encoders):
    variables, img, _, patch = encoders
    ind = np.array([[40, 200], [0, 255]], np.int32)
    jmod = JaxFPNEncoder(heads=HEADS, knn_method="topk",
                         gather_method="take", patch_heads=True,
                         dtype=jnp.float32, **ENC)
    _, _, ret_j, _, _ = jax.jit(lambda v, i: jmod.apply(
        v, i, None, None, jnp.asarray(ind), False, mode="image"))(
            variables, img)
    with torch.inference_mode():
        _, _, ret_t, _, _ = patch.image_phase(_nchw(img),
                                              torch.from_numpy(ind))
    for h in HEADS:
        got = ret_t[h].numpy() if h != "hm" else _nhwc(ret_t[h])
        np.testing.assert_allclose(got, np.asarray(ret_j[h]), **TOL,
                                   err_msg=h)


# ---- s2d_stem ----------------------------------------------------------------

def test_s2d_resnet_matches_jax():
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    variables = _variables(JaxResNet(dtype=jnp.float32), x[:1], False,
                           seed=2)
    jmod = JaxResNet(s2d_stem=True, dtype=jnp.float32)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, False))(variables, x)
    s2d = _port(ResNet(s2d_stem=True), variables)
    plain = _port(ResNet(), variables)
    with torch.inference_mode():
        got, base = s2d(_nchw(x)), plain(_nchw(x))
    assert len(got) == len(ref) == 5
    for g, r, b in zip(got, ref, base):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)
        np.testing.assert_allclose(g.numpy(), b.numpy(), atol=2e-5,
                                   rtol=1e-5)


# ---- use_img_attn -------------------------------------------------------------

def test_img_attn_matches_jax():
    """One ``ImgAttn`` (its raw ``pos_emb`` parameter carried by
    ``convert``'s bare-parameter rule)."""
    rng = np.random.RandomState(3)
    img = rng.randn(2, 12, 12, 32).astype(np.float32)
    verts = rng.randn(2, 63, 16).astype(np.float32)
    jmod = JaxImgAttn(img_size=12, img_f_dim=32, grid_size=6, grid_f_dim=24,
                      verts_f_dim=16, dtype=jnp.float32)
    variables = _variables(jmod, img, verts, False, seed=4)
    assert "pos_emb" in variables["params"]
    ref = jmod.apply(variables, img, verts, False)
    tmod = _port(ImgAttn(12, 32, 6, 24, 16), variables)
    torch.testing.assert_close(
        tmod.pos_emb.detach(),
        torch.from_numpy(np.asarray(variables["params"]["pos_emb"])))
    with torch.inference_mode():
        got = tmod(_nchw(img), torch.from_numpy(verts))
    assert got.shape == (2, 63, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_mesh_decoder_with_img_attn_matches_jax():
    rng = np.random.RandomState(5)
    B, sizes = 2, (6, 12, 24)
    gf_l, gf_r = rng.randn(2, B, 1024).astype(np.float32)
    fmaps = [rng.randn(B, s, s, 256).astype(np.float32) for s in sizes]
    kw = dict(use_img_attn=True, img_sizes=sizes)
    jmod = JaxMeshDecoder(stack_hands=True, **kw)
    variables = _variables(jmod, gf_l, gf_r, fmaps, False, seed=6)
    result, params, _, _ = jax.jit(
        lambda v, a, b, f: jmod.apply(v, a, b, f, False))(
            variables, gf_l, gf_r, fmaps)
    tmod = _port(MeshDecoder(**kw), variables)
    with torch.inference_mode():
        t_res, t_par, _, _ = tmod(torch.from_numpy(gf_l),
                                  torch.from_numpy(gf_r),
                                  [_nchw(f) for f in fmaps])
    for side in ("left", "right"):
        for d, td in ((result["verts3d"], t_res["verts3d"]),
                      (result["verts2d"], t_res["verts2d"]),
                      (params["root"], t_par["root"])):
            _close_scaled(td[side].numpy(), np.asarray(d[side]))


OPTIONS = dict(default_resolution=192, compute_dtype="float32",
               sample_num=256, sample_num_level1=128, sample_num_level2=128,
               knn_k=8, knn_method="topk", gather_method="take",
               patch_heads=True, s2d_stem=True, use_img_attn=True)


def test_eval_step_with_the_options_matches_jax():
    """``patch_heads``, ``s2d_stem`` and ``use_img_attn`` together through
    ``make_eval_step`` (the generic ``topk`` grouping on both sides)."""
    cfg_j = JaxConfig(**OPTIONS)
    batch = _batch(1, 192, 256)
    variables = jax_variables(cfg_j, batch)
    assert "img_ex_left" in variables["params"]["decoder"]["level0"]
    step = jax_eval_step(cfg_j, jax_build_model(cfg_j), jax_consts())
    ref = step(variables["params"], variables["batch_stats"],
               {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = port.Config(**OPTIONS)
    model = port.HandNet(cfg).eval()
    model.load_state_dict(convert.from_flax(variables, model))
    got = port.make_eval_step(cfg, model, port.load_loss_consts("cpu"))(batch)
    assert set(got) == set(ref)
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), **STEP_TOL,
                                   err_msg=k)


# ---- knn_method="approx" -----------------------------------------------------

def _cloud(case, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(3, 256, 3) * 0.05).astype(np.float32)
    if case == "duplicates":      # repeated points: exact distance ties
        pts[:, 128:192] = pts[:, :64]
    elif case == "grid":          # a 1 cm lattice: many bf16 ties
        g = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"), -1)
        pts = np.tile(g.reshape(-1, 3)[:256][None] * 0.01, (3, 1, 1))
        pts = rng.permutation(pts.transpose(1, 0, 2)).transpose(1, 0, 2)
        pts = np.ascontiguousarray(pts, np.float32)
    return pts


@pytest.mark.parametrize("case", ["random", "duplicates", "grid"])
@pytest.mark.parametrize("k", [8, 64])
def test_approx_selection(case, k):
    S, r2 = 128, 0.0015
    pts = _cloud(case)
    c = torch.from_numpy(pts[:, :S])
    d2 = grouping._pairwise_sqdist(c, torch.from_numpy(pts))
    d2_j = np.asarray(jax_grouping._pairwise_sqdist(jnp.asarray(pts[:, :S]),
                                                    jnp.asarray(pts)))
    np.testing.assert_array_equal(d2.numpy(), d2_j)
    dist, idx = grouping.approx_select(d2, k)
    neg_a, _ = jax.lax.approx_max_k(-jnp.asarray(d2_j).astype(jnp.bfloat16),
                                    k, recall_target=0.95)
    neg_t, idx_t = jax.lax.top_k(-jnp.asarray(d2_j).astype(jnp.bfloat16), k)
    # the selected distances, bit for bit, in JAX's float32 widening
    np.testing.assert_array_equal(
        dist.numpy(), -np.asarray(neg_a.astype(jnp.float32)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_t))
    # the properties of the selection: k distinct points, ascending, none
    # left out nearer (in bf16) than the farthest taken
    d2_bf = d2.to(torch.bfloat16).float()
    assert (dist == d2_bf.gather(-1, idx)).all()
    assert (dist[..., 1:] >= dist[..., :-1]).all()
    assert all(len(set(r)) == k for r in idx.reshape(-1, k).tolist())
    taken = torch.zeros_like(d2_bf, dtype=torch.bool).scatter_(-1, idx, True)
    assert (d2_bf[~taken].reshape(3, S, -1).amin(-1)
            >= dist[..., -1]).all()
    # the ball query on those bf16 distances, as JAX decides it
    qidx, valid = grouping.knn_ball_query(c, torch.from_numpy(pts), k, r2,
                                          "approx")
    jidx, jvalid = jax_grouping.knn_ball_query(
        jnp.asarray(pts[:, :S]), jnp.asarray(pts), k, r2, "approx")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert torch.equal(valid, dist <= np.float32(r2))
    center = torch.arange(S)[None, :, None].expand_as(qidx)
    assert torch.equal(qidx, torch.where(valid, idx, center))
    # JAX's indices differ only inside a run of equal bf16 distances
    same = np.asarray(jidx) == qidx.numpy()
    assert (d2_bf.gather(-1, torch.from_numpy(np.asarray(jidx)).long())[
        ~torch.from_numpy(same)] == dist[~torch.from_numpy(same)]).all()


# ---- the exported ops --------------------------------------------------------

def test_exported_ops_match_jax():
    rng = np.random.RandomState(7)
    feat = rng.randn(2, 50, 6).astype(np.float32)
    ind = rng.randint(0, 50, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_feat(torch.from_numpy(feat), torch.from_numpy(ind)).numpy(),
        np.asarray(jax_gather.gather_feat(feat, ind)))

    scores = rng.randint(0, 5, (3, 6, 7)).astype(np.float32)   # many ties
    for k in (1, 5, 42):
        got = ops.heatmap_topk(torch.from_numpy(scores), k)
        ref = jax_heatmap.heatmap_topk(jnp.asarray(scores), k)
        for g, r in zip(got, ref):
            assert g.shape == (3, k)
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    x = rng.randn(2, 63, 8).astype(np.float32)
    L = (rng.randn(63, 63) * 0.1).astype(np.float32)
    for K, bias in ((1, None), (2, rng.randn(5)), (3, rng.randn(5))):
        w = rng.randn(8 * K, 5).astype(np.float32)
        b = None if bias is None else bias.astype(np.float32)
        got = ops.cheb_conv(torch.from_numpy(x), torch.from_numpy(L),
                            torch.from_numpy(w),
                            None if b is None else torch.from_numpy(b), K)
        ref = jax_cheb.cheb_conv(jnp.asarray(x), jnp.asarray(L),
                                 jnp.asarray(w),
                                 None if b is None else jnp.asarray(b), K)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **REL)
