"""The photometric loss of the port (``photometric_loss=True``): the
renderer's forward and its gradients, the loss terms, the train step and the
trainer's image summaries, against the JAX package on the same inputs.

- ``rasterize_mesh`` keeps only each pixel's winning face from a depth test
  without gradients and recomputes that face's barycentrics; its outputs
  must be those of the plain chunked z-buffer (``_chunked``, the expressions
  on (face_chunk, P) tensors) bit for bit.
- ``render_two_hands(..., vert_colors=...)``: ``fid`` and the mask equal to
  JAX's, rgb and depth within 1e-5 (``test_torch_render.py``'s bar), and the
  gradients of seeded cotangents on rgb and depth w.r.t. the vertices and
  the colors within 1e-5 of each gradient's largest entry of ``jax.vjp``'s
  (float32 sums in another order; a wrong path is off by O(1)).
- ``compute_loss`` on seeded model outputs (hands on screen): every stat
  within 1e-5 relative (``test_torch_loss.py``'s bar) and the gradients
  w.r.t. every output within 1e-5 of each one's largest entry, with the
  texture and light heads as full maps and as ``patch_heads`` values.
- The whole train step at res 64 with and without ``patch_heads``, JAX's
  neighbour selections replayed: every loss term within 2e-4 and every
  gradient leaf within 1e-2 of its norm, ``test_torch_train_step.py``'s
  bars and reasons (another float32 evaluation order through ResNet-50).
- ``Trainer.image_summary`` against the JAX ``Trainer.image_summary`` on the
  same eval outputs: the uint8 grids within 1 grey level (the renders
  differ in the last float32 bits, then truncate to uint8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import build_model as jax_build_model
from pdfnet_tpu.ops import grouping, pallas_knn
from pdfnet_tpu.render import rasterizer as jax_rast
from pdfnet_tpu.train.loss import compute_loss as jax_compute_loss
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts
from pdfnet_tpu.train.trainer import Trainer as JaxTrainer

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch import assets, convert
from pdfnet_tpu_torch.ops import grouping as port_grouping
from pdfnet_tpu_torch.ops import sa
from pdfnet_tpu_torch.ops.sa import knn_plain as sa_knn_plain
from pdfnet_tpu_torch.render import rasterizer
from pdfnet_tpu_torch.train.trainer import Logger, Trainer

from test_torch_eval_step import jax_variables
from test_torch_loss import _map, _outputs
from test_torch_train_step import _assert_grads_close, _recording
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8,
             batch_size=2, dropout=0.0, freeze_bn_stats=True,
             photometric_loss=True)
EPOCH = 30
TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
STEP_LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
GRAD_SCALE_TOL = 1e-5
FACES = (assets.load_mano("left").faces, assets.load_mano("right").faces)


def _hands(seed, res):
    """Two MANO template hands about 0.5 m in front of a camera at ``res``,
    and their K."""
    rng = np.random.RandomState(seed)
    vl = assets.load_mano("left").v_template + [-0.04, 0.0, 0.5]
    vr = assets.load_mano("right").v_template + [0.04, 0.01, 0.55]
    vl, vr = (v + rng.randn(778, 3) * 1e-3 for v in (vl, vr))
    f = res * 1.6
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1]])
    return [np.asarray(a, np.float32) for a in (vl, vr, K)]


def _chunked(verts2d, z, faces, h, w, face_chunk=128):
    """The plain chunked z-buffer: every chunk's barycentrics as (C, P)
    tensors, the winner's gathered (the rasterizer before its depth test
    ran without gradients)."""
    F = faces.shape[0]
    pad = (-F) % face_chunk
    faces_p = torch.cat([faces, faces.new_zeros((pad, 3))])
    fxy, fz = verts2d[faces_p], z[faces_p]
    ys = torch.arange(h, dtype=torch.float32) + 0.5
    xs = torch.arange(w, dtype=torch.float32) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([px, py], -1).reshape(-1, 2)
    P = pix.shape[0]
    zbuf = torch.full((P,), float("inf"))
    fid = torch.full((P,), -1, dtype=torch.int32)
    bary = torch.zeros((P, 3))
    rows = torch.arange(face_chunk)[:, None]
    edge = rasterizer._edge
    for start in range(0, F + pad, face_chunk):
        cxy, cz = fxy[start:start + face_chunk], fz[start:start + face_chunk]
        a, b, c = cxy[:, None, 0], cxy[:, None, 1], cxy[:, None, 2]
        w0, w1, w2 = edge(b, c, pix), edge(c, a, pix), edge(a, b, pix)
        area = edge(a, b, c)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) |
                  ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
        denom = torch.where(area.abs() < 1e-9, torch.ones_like(area), area)
        zi = (w0 / denom * cz[:, 0:1] + w1 / denom * cz[:, 1:2] +
              w2 / denom * cz[:, 2:3])
        ok = (inside & ((start + rows) < F) & (area.abs() > 1e-9)
              & (zi > 0))
        zi = torch.where(ok, zi, torch.full_like(zi, float("inf")))
        best_z = zi.amin(dim=0)
        best = torch.where(zi == best_z, rows, face_chunk).amin(dim=0)
        hit = best_z < zbuf
        zbuf = torch.where(hit, best_z, zbuf)
        fid = torch.where(hit, (best + start).to(torch.int32), fid)
        sel = lambda t: (t.gather(0, best[None]) /
                         denom[:, 0].gather(0, best))[0]
        bary = torch.where(hit[:, None],
                           torch.stack([sel(w0), sel(w1), sel(w2)], -1), bary)
    zbuf = torch.where(torch.isinf(zbuf), torch.zeros_like(zbuf), zbuf)
    return zbuf.reshape(h, w), fid.reshape(h, w), bary.reshape(h, w, 3)


@pytest.mark.parametrize("case", ["hands", "random", "ties"])
def test_rasterizer_forward_is_the_chunked_zbuffer(case):
    res = 96
    if case == "hands":
        vl, vr, K = (torch.from_numpy(a) for a in _hands(0, res))
        verts = torch.cat([vl, vr])
        proj = verts @ K.T
        v2d, z = proj[:, :2] / (proj[:, 2:] + 1e-8), verts[:, 2]
        faces = torch.from_numpy(np.concatenate(
            [FACES[0][:, ::-1], FACES[1] + 778]).astype(np.int64))
    else:
        g = torch.Generator().manual_seed(1)
        v2d = torch.rand(300, 2, generator=g) * res
        z = torch.rand(300, generator=g) + 0.1
        faces = torch.randint(0, 300, (500, 3), generator=g)
        if case == "ties":          # equal z everywhere: index order decides
            z = torch.full((300,), 0.5)
    got = rasterizer.rasterize_mesh(v2d, z, faces, res, res)
    want = _chunked(v2d, z, faces, res, res)
    assert (got[1] >= 0).sum() > 100
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype
        assert torch.equal(g_, w_)


def test_render_with_colors_forward_and_gradients():
    res = 64
    vl, vr, K = _hands(2, res)
    rng = np.random.RandomState(3)
    cols = rng.uniform(0, 1, (1556, 3)).astype(np.float32)
    g_rgb = rng.randn(res, res, 3).astype(np.float32)
    g_depth = rng.randn(res, res).astype(np.float32)

    def jax_render(a, b, c):
        rgb, mask, depth = jax_rast.render_two_hands(
            a, b, jnp.asarray(K), FACES[0], FACES[1], res, res,
            vert_colors=c)
        return rgb, depth, mask

    (rgb_j, depth_j, mask_j), vjp = jax.vjp(jax_render, vl, vr, cols)
    grads_j = vjp((g_rgb, g_depth, np.zeros((res, res), np.float32)))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (vl, vr, cols)]
    rgb, mask, depth = rasterizer.render_two_hands(
        leaves[0], leaves[1], torch.from_numpy(K), FACES[0], FACES[1], res,
        res, vert_colors=leaves[2])
    assert not mask.requires_grad
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert mask.sum() > 200
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), **TOL)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(depth_j),
                               **TOL)
    (torch.sum(rgb * torch.from_numpy(g_rgb))
     + torch.sum(depth * torch.from_numpy(g_depth))).backward()
    for name, leaf, ref in zip(("verts_left", "verts_right", "colors"),
                               leaves, grads_j):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_SCALE_TOL * scale,
                                   err_msg=name)


def _photometric_outputs(cfg, batch, seed, patch):
    """``test_torch_loss._outputs`` with the hands on screen: the predicted
    offsets are the ground truth's plus 1 mm of noise and the root code is
    small (the root lands at the ground-truth center pixel, ~0.4 m deep);
    under ``patch`` the texture and light heads are (B, 2, C)."""
    result, params, hand_dicts, other = _outputs(cfg, batch, seed)
    rng = np.random.RandomState(seed + 1)
    for side in ("left", "right"):
        gt = batch[f"verts_{side}_gt"] - batch[f"joints_{side}_gt"][:, 9:10]
        result["verts3d"][side] = (gt + rng.randn(*gt.shape) * 1e-3).astype(
            np.float32)
        params["root"][side] = (rng.randn(2, 3) * 0.5).astype(np.float32)
    if patch:
        for head in ("texture", "light"):
            c = other["ret"][head].shape[-1]
            other["ret"][head] = rng.randn(2, 2, c).astype(np.float32)
    return result, params, hand_dicts, other


@pytest.fixture(scope="module")
def loss_consts():
    return jax_consts(), port.load_loss_consts("cpu")


@pytest.mark.parametrize("patch", [False, True], ids=["full_maps",
                                                      "patch_heads"])
def test_compute_loss_photometric_matches_jax(loss_consts, patch):
    cfg_t = port.Config(**SMALL, patch_heads=patch)
    cfg_j = JaxConfig(**SMALL, patch_heads=patch)
    batch = port.make_batch(cfg_t, 2, seed=3)
    outs = _photometric_outputs(cfg_t, batch, 4, patch)
    ind = outs[3].pop("ind")                 # integer: not differentiated
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_j(o):
        result, params, hand_dicts, other = o
        return jax_compute_loss(cfg_j, loss_consts[0], result, params,
                                hand_dicts, {**other, "ind": ind}, jb,
                                jnp.asarray(EPOCH), mode="train")

    (total_j, stats_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        _map(outs, jnp.asarray))
    leaves = _map(outs, lambda a: torch.from_numpy(a).requires_grad_())
    result, params, hand_dicts, other = leaves
    total_t, stats_t = port.compute_loss(
        cfg_t, loss_consts[1], result, params, hand_dicts,
        {**other, "ind": torch.from_numpy(ind)},
        {k: torch.from_numpy(v) for k, v in batch.items()}, EPOCH,
        mode="train")
    assert sorted(stats_t) == sorted(stats_j)
    assert float(stats_t["photometric_loss"]) > 0
    for k in stats_j:
        np.testing.assert_allclose(stats_t[k].detach().numpy(),
                                   np.asarray(stats_j[k]), err_msg=k,
                                   **LOSS_TOL)
    total_t.backward()
    checked = []

    def compare(path, t, g):
        g = np.asarray(g)
        got = (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()
        scale = max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=GRAD_SCALE_TOL * scale,
                                   err_msg="/".join(map(str, path)))
        checked.append(path)

    def walk(t, g, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], g[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, (a, b) in enumerate(zip(t, g)):
                walk(a, b, path + (i,))
        else:
            compare(path, t, g)

    walk(leaves, grads_j)
    texture = (3, "ret", "texture")
    assert texture in checked and np.abs(
        np.asarray(grads_j[3]["ret"]["texture"])).max() > 0


def _jax_train_grads(cfg, batch, variables):
    """JAX: the first step's stats and gradients, and every grouping
    call's selection (``test_torch_train_step.run_jax``, one step)."""
    model, consts = jax_build_model(cfg), jax_consts()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        (result, p_dict, hd, other), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb["input"], jb["choose"], jb["cloud"], jb["depth"], jb["ind"],
            jb["K_new"], jb["valid"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jax_compute_loss(cfg, consts, result, p_dict, hd, other, jb,
                                jnp.asarray(EPOCH), mode="train")

    selections = []
    saved = (grouping._FUSED_INTERPRET, pallas_knn.knn_gather_xyz_pallas,
             pallas_knn.group_feat_pallas)
    grouping._FUSED_INTERPRET = True
    pallas_knn.knn_gather_xyz_pallas = _recording(
        saved[1], lambda out: (out[0], out[1]), selections)
    pallas_knn.group_feat_pallas = _recording(
        saved[2], lambda out: (out[2], out[1]), selections)
    try:
        (_, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        stats, grads = jax.tree.map(np.asarray, (stats, grads))
        jax.effects_barrier()
    finally:
        (grouping._FUSED_INTERPRET, pallas_knn.knn_gather_xyz_pallas,
         pallas_knn.group_feat_pallas) = saved
    assert len(selections) == 2
    return stats, grads, selections


@pytest.mark.parametrize("patch", [False, True], ids=["full_maps",
                                                      "patch_heads"])
def test_photometric_train_step_matches_jax(patch):
    """Frozen BatchNorm, no dropout, the JAX step's neighbours replayed on
    the port's plain grouping (see ``test_torch_train_step.run_port``)."""
    cfg_j = JaxConfig(**SMALL, patch_heads=patch)
    cfg_t = port.Config(**SMALL, patch_heads=patch)
    batch = port.make_batch(cfg_t, 2, seed=0)
    variables = jax_variables(cfg_j, batch)
    head = variables["params"]["decoder"]["coord_head"]
    head.update({k: v * np.float32(0.01) for k, v in head.items()})
    stats_j, grads_j, selections = _jax_train_grads(cfg_j, batch, variables)

    def knn_plain(xyz, num_centers, k):
        _, idx = sa_knn_plain(xyz, num_centers, k)
        ref, ref_idx = selections.pop(0)
        if ref.dtype == np.bool_:   # group_feat_pallas returns validity
            ref = np.where(ref, np.float32(0), np.float32(np.inf))
        return (torch.from_numpy(np.array(ref)),
                torch.from_numpy(ref_idx.astype(np.int64)))

    model = port.HandNet(cfg_t)
    model.load_state_dict(convert.from_flax(variables, model))
    model.train()
    step = port.make_train_step(cfg_t, model, port.load_loss_consts("cpu"))
    saved = (port_grouping.knn_plain, sa.knn_plain)
    port_grouping.knn_plain = sa.knn_plain = knn_plain
    try:
        stats_t = step(port.create_train_state(cfg_t, model), batch, EPOCH,
                       1e-4)
    finally:
        port_grouping.knn_plain, sa.knn_plain = saved
    assert not selections
    assert sorted(stats_t) == sorted(stats_j)
    assert float(stats_j["photometric_loss"]) > 0
    for k in stats_j:
        np.testing.assert_allclose(stats_t[k].numpy(), stats_j[k], err_msg=k,
                                   **STEP_LOSS_TOL)
    grads_t = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
               for n, p in model.named_parameters()}
    grads = convert.params_from_flax(grads_j, model)
    for head in ("texture", "light"):
        assert grads[f"encoder.head_{head}.conv1.weight"].abs().max() > 0
    assert _assert_grads_close(grads_t, grads, sorted(grads_t)) >= \
        0.9 * len(grads_t)


class _Stub:
    """What ``image_summary`` reads of a trainer."""


def test_image_summary_matches_jax(tmp_path):
    """Both trainers' ``image_summary`` on the same eval outputs (hands on
    screen, ground truth beside them), and the port's written through
    ``Logger.image``."""
    import cv2
    res, B = 64, 5
    cfg = port.Config(default_resolution=res)
    rng = np.random.RandomState(5)
    hands = [_hands(s, res) for s in range(B)]
    verts = np.stack([[vl, vr] for vl, vr, _ in hands])      # (B, 2, 778, 3)
    batch = {"input": rng.randn(B, res, res, 3).astype(np.float32),
             "K_new": np.stack([K for _, _, K in hands])}
    outs = {"verts_pred": verts,
            "verts_gt": verts + rng.randn(*verts.shape).astype(
                np.float32) * 2e-3}

    jax_stub, jax_stub.state = _Stub(), _Stub()
    jax_stub.cfg = JaxConfig(default_resolution=res)
    jax_stub.state.params = jax_stub.state.batch_stats = None
    jax_stub.eval_step = lambda p, s, b: {k: v[:b["input"].shape[0]]
                                          for k, v in outs.items()}
    want = JaxTrainer.image_summary(jax_stub, batch)

    port_stub = _Stub()
    port_stub.cfg, port_stub.state = cfg, object()
    port_stub.device = torch.device("cpu")
    port_stub.consts = port.load_loss_consts("cpu")
    port_stub.eval_step = lambda b: {k: torch.from_numpy(v[:len(b["input"])])
                                     for k, v in outs.items()}
    got = Trainer.image_summary(port_stub, batch)
    assert got.dtype == np.uint8 and got.shape == want.shape == (4 * res,
                                                                 3 * res, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    # the renders are laid over the input where the hands are
    assert (got[:, res:2 * res] != got[:, :res]).any()
    logger = Logger(str(tmp_path), cfg)
    path = logger.image(7, "train", got)
    logger.close()
    np.testing.assert_array_equal(cv2.imread(path), got)
