"""``HandNet`` at ``input_feature_num=6`` with ``sample_strategy="FPS"``
against the JAX model: the batched eval step (forward + ``eval_outputs``)
and the train step's loss terms and gradients with frozen BatchNorm and no
dropout; and the self-contained path's hand-over of both options to the
cloud builder.

Both sides take ``knn_method="pallas_sa"`` (the default) at a small float32
config, with the same seeded weights (``convert.from_flax``) on the same
batch: the port's ``make_batch`` with FPS-ordered clouds of xyz + surface
normals.  Six channels leave the fused SA kernels on both sides
(``pointnet.py:127-132``): level 1 is the generic kNN + exact gather (the
port's ``knn`` selection; JAX's ``top_k`` of the matmul expansion off the
TPU) and level 2 the fused feature grouping (the port's ``group_feat``;
JAX's ``group_feat_pallas`` in interpret mode).

The synthetic hands' depth is constant over 8x8-pixel blocks, so their
points lie on a grid and neighbour distances tie exactly; the two
selections break ties at the k-th place differently (the expansion's
rounding), so the port replays JAX's selections at both levels, and the
number of slots where its own differ is printed (the selections themselves
are held to the TPU kernels in ``test_torch_knn.py`` and
``test_torch_grouping.py``).  Tolerances are those of the existing model
tests: ``test_torch_eval_step.py``'s 2e-4 on every output, and
``test_torch_train_step.py``'s loss terms (2e-4 relative) and gradients
(1e-2 of each leaf's norm).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import build_model as jax_build_model
from pdfnet_tpu.ops import grouping as jax_grouping
from pdfnet_tpu.ops import pallas_knn
from pdfnet_tpu.train.loss import compute_loss as jax_compute_loss
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts
from pdfnet_tpu.train.step import make_eval_step as jax_eval_step

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.ops import grouping, sa

from test_torch_eval_step import TOL, jax_variables
from test_torch_train_step import LOSS_TOL, _assert_grads_close, _recording
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8,
             sample_strategy="FPS", input_feature_num=6, batch_size=2,
             dropout=0.0, freeze_bn_stats=True)
EPOCH, LR = 30, 1e-4


def _batch():
    b = port.make_batch(port.Config(**SMALL), 2, seed=3)
    assert b["cloud"].shape == (2, 2, 256, 6) and b["valid"].sum() >= 3
    return b


@contextlib.contextmanager
def jax_recording(level1, level2):
    """JAX in interpret mode, each level's selection sent to a list from
    inside the jitted step: level 1 (``knn_ball_query``: idx, valid),
    level 2 (``group_feat_pallas``: valid, idx)."""
    saved = (jax_grouping._FUSED_INTERPRET, jax_grouping.knn_ball_query,
             pallas_knn.group_feat_pallas)
    jax_grouping._FUSED_INTERPRET = True
    jax_grouping.knn_ball_query = _recording(
        saved[1], lambda out: (out[0], out[1]), level1)
    pallas_knn.group_feat_pallas = _recording(
        saved[2], lambda out: (out[2], out[1]), level2)
    try:
        yield
        jax.effects_barrier()
    finally:
        (jax_grouping._FUSED_INTERPRET, jax_grouping.knn_ball_query,
         pallas_knn.group_feat_pallas) = saved


@contextlib.contextmanager
def port_replaying(level1, level2, flips):
    """The port's selections replaced by JAX's recorded ones, in call order;
    ``flips`` counts [slots where the port's own differ, slots]."""
    knn_ball_query, knn_plain = grouping.knn_ball_query, sa.knn_plain

    def replay_level1(centers, points, k, radius2, method):
        idx, _ = knn_ball_query(centers, points, k, radius2, method)
        ref_idx, ref_valid = level1.pop(0)
        ref_idx = torch.from_numpy(ref_idx.astype(np.int64))
        flips[0] += int((idx != ref_idx).sum())
        flips[1] += idx.numel()
        return ref_idx, torch.from_numpy(np.array(ref_valid))

    def replay_level2(xyz, num_centers, k):
        _, idx = knn_plain(xyz, num_centers, k)
        ref_valid, ref_idx = level2.pop(0)
        ref_idx = torch.from_numpy(ref_idx.astype(np.int64))
        flips[0] += int((idx != ref_idx).sum())
        flips[1] += idx.numel()
        dist = np.where(ref_valid, np.float32(0), np.float32(np.inf))
        return torch.from_numpy(dist), ref_idx

    grouping.knn_ball_query = replay_level1
    sa.knn_plain = replay_level2
    try:
        yield
    finally:
        grouping.knn_ball_query, sa.knn_plain = knn_ball_query, knn_plain
    assert not level1 and not level2, "fewer groupings than JAX's"


def _port_model(variables, train):
    cfg = port.Config(**SMALL)
    model = port.HandNet(cfg)
    model.load_state_dict(convert.from_flax(variables, model))
    return cfg, model.train(train)


def test_eval_step_matches_jax():
    batch = _batch()
    cfg_j = JaxConfig(**SMALL)
    variables = jax_variables(cfg_j, batch)
    level1, level2 = [], []
    with jax_recording(level1, level2):
        step = jax_eval_step(cfg_j, jax_build_model(cfg_j), jax_consts())
        ref = step(variables["params"], variables["batch_stats"],
                   {k: jnp.asarray(v) for k, v in batch.items()})
        ref = {k: np.asarray(v) for k, v in ref.items()}
    assert len(level1) == len(level2) == 1

    cfg, model = _port_model(variables, train=False)
    flips = [0, 0]
    sa.reset_launches()
    grouping.reset_launches()
    with port_replaying(level1, level2, flips):
        got = port.make_eval_step(cfg, model,
                                  port.load_loss_consts("cpu"))(batch)
    print(f"eval: the port's own selection differs from JAX's in "
          f"{flips[0]} of {flips[1]} slots")
    assert sorted(got) == sorted(ref)
    for k in ref:
        g = got[k].numpy()
        assert g.shape == ref[k].shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, ref[k], err_msg=k, **TOL)
    # CPU tensors: the plain versions, no kernel launched
    assert not any(sa.launches.values()) and not any(
        grouping.launches.values())


def test_train_step_matches_jax():
    """The first step's loss terms and every gradient leaf.  One test, so
    that one process compiles the JAX gradient."""
    batch = _batch()
    cfg_j = JaxConfig(**SMALL)
    variables = jax_variables(cfg_j, batch)
    # hand-sized vertex offsets, as test_torch_train_step.run_jax sets them
    head = variables["params"]["decoder"]["coord_head"]
    head.update({k: v * np.float32(0.01) for k, v in head.items()})
    model_j, consts = jax_build_model(cfg_j), jax_consts()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        (result, p_dict, hd, other), _ = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb["input"], jb["choose"], jb["cloud"], jb["depth"], jb["ind"],
            jb["K_new"], jb["valid"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jax_compute_loss(cfg_j, consts, result, p_dict, hd, other, jb,
                                jnp.asarray(EPOCH), mode="train")

    level1, level2 = [], []
    with jax_recording(level1, level2):
        (_, stats_j), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        stats_j = jax.tree.map(np.asarray, stats_j)
        grads_j = jax.tree.map(np.asarray, grads_j)

    cfg, model = _port_model(variables, train=True)
    step = port.make_train_step(cfg, model, port.load_loss_consts("cpu"))
    flips = [0, 0]
    with port_replaying(level1, level2, flips):
        stats = step(port.create_train_state(cfg, model), batch, EPOCH, LR)
    print(f"train: the port's own selection differs from JAX's in "
          f"{flips[0]} of {flips[1]} slots")
    assert sorted(stats) == sorted(stats_j)
    for k in stats_j:
        np.testing.assert_allclose(stats[k].numpy(), stats_j[k], err_msg=k,
                                   **LOSS_TOL)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    want = convert.params_from_flax(grads_j, model)
    assert _assert_grads_close(grads, want, sorted(grads)) >= 0.9 * len(grads)
    level1_grad = grads["encoder.pointnet.mlp1.fc0.weight"]
    assert level1_grad.shape[1] == 6 and level1_grad.abs().sum() > 0


def test_infer_rgbd_builds_fps_normal_clouds():
    """The self-contained path hands both options to the cloud builder (the
    JAX model's ``handnet.py:72-78``), whose output the point phase takes:
    six channels, unit normals, FPS-ordered (its parity with JAX is in
    ``test_torch_pointcloud.py``)."""
    import pdfnet_tpu_torch.models.handnet as handnet
    cfg = port.Config(**dict(SMALL, sample_deterministic=True))
    model = port.build_model(cfg, device="cpu")
    with torch.no_grad():        # both masks cover the whole image
        model.encoder.dp_decoder.head.bias.fill_(10.0)
    b = _batch()
    calls = []
    build = handnet.depth_to_hand_clouds

    def recording(*a, **k):
        calls.append((a, k, build(*a, **k)))
        return calls[-1][2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(handnet, "depth_to_hand_clouds", recording)
        out = port.infer_rgbd(model, *(b[k] for k in ("input", "depth",
                                                       "K_new", "valid")))
    (args, kw, (choose, cloud, ok)), = calls
    assert kw["with_normals"] and kw["fps_levels"] == (128, 128)
    assert cloud.shape == (2, 2, 256, 6) and ok.all()
    torch.testing.assert_close(cloud[..., 3:].norm(dim=-1),
                               torch.ones(2, 2, 256))
    d2 = lambda c: ((c[:, :, :, None, :3] - c[:, :, None, :, :3]) ** 2).sum(-1)
    # the FPS prefix is spread wider than the cloud's first points unordered
    unordered = build(*args, **dict(kw, fps_levels=None))[1]
    prefix = lambda c: d2(c[:, :, :16]).add(torch.eye(16) * 1e9).amin((-1, -2))
    assert (prefix(cloud) > prefix(unordered)).all()
    assert np.isfinite(out[0]["verts3d"]["left"].numpy()).all()
