"""The 2-D (data x model) layout of the port (``parallel/mesh.py``:
``make_mesh_2d``, ``tp_plan``, ``shard_params_tp``) against the JAX
package's placement, and its train, eval and serving steps over four gloo
ranks, (2 data x 2 model), against the port's one process on the same
global batch and weights, in one test (``test_2d_layout_over_four_ranks``)
whose parts fail with their own messages.

The JAX side is held transitively where that is cheaper: the port's one
process is held to JAX by ``tests/test_torch_train_step.py``,
``test_torch_eval_step.py`` and ``test_torch_infer.py``; the plan is held
to JAX's ``shard_params_tp`` itself.  Each rank takes its stripe of the
global batch by data index.

Bounds.  A split Linear or convolution computes its slice of the output
channels with other float32 summation orders than the whole one, so a ReLU
input within rounding of zero can flip (one at 5e-7 in ``layer3_5``): in
the frozen-BatchNorm train step with dropout, the gradients lie up to
1.1e-3 of a leaf's norm from one process's, 2.7e-5 as one vector, where
the one process itself moves by up to 7.9e-3 of a leaf (``e_conv1``,
feeding the cancelling level-0 SFT) and 8.8e-5 as one vector between one
and two torch threads; each split module alone agrees to 1e-14 in float64
(``split_modules_are_exact_in_float64``).  The steps run with frozen
BatchNorm and are held by ``test_torch_parallel.assert_near_one_process``
(the gradients as one vector within ``GRAD_RTOL["handnet"]``, each leaf
within ``MOMENT_RTOL``); live BatchNorm over the layout's cuts is held in
float64 (``cuts_are_exact_in_float64``), where no order amplifies.  The
eval and serving outputs within ``EVAL_TOL`` (below).
"""

import numpy as np
import pytest
import torch

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch.parallel import mesh

from test_torch_parallel import (GRAD_RTOL, assert_f64_cuts_match,
                                 assert_near_one_process)
from test_torch_ranks import (SMALL, RankGroup, column_parallel_gaps,
                              conv_act_bn_cuts, conv_act_bn_weights,
                              eval_outputs_of, seeded_state, train_steps)
from test_torch_threads import one_torch_thread  # noqa: F401

MESH = (2, 2)
# the eval and serving outputs of the (2 x 2) ranks against one process:
# float32 roundings through the split matmuls (largest seen 5.5e-7 of an
# output's largest entry at eval, 1.0e-6 serving)
EVAL_TOL = dict(rtol=1e-4, atol=1e-5)


# ---- the plan against JAX's placement --------------------------------------

@pytest.fixture(scope="module")
def full_model():
    return port.HandNet(port.Config())


@pytest.mark.parametrize("data,model,held", [(4, 2, 46_935_255),
                                             (2, 4, 26_200_899)])
def test_plan_matches_jax(data, model, held, full_model):
    """At the default ``Config``'s full width, the leaves the port splits
    and each slice's shape equal JAX ``shard_params_tp`` on
    ``make_mesh_2d(data, model)`` over the 8 virtual CPU devices: JAX's
    rule reads only a leaf's ndim and last axis, so it is handed arrays of
    shape ``(1,) * (ndim - 1) + (last,)`` built from the port's shapes
    through ``convert.flax_last_dim``; its ``.sharding`` gives each slice.
    Each rank holds the parameter count the JAX placement gives it."""
    import jax.numpy as jnp

    from pdfnet_tpu.parallel import mesh as jax_mesh

    from pdfnet_tpu_torch import convert

    params = dict(full_model.named_parameters())
    last = {n: p.shape[convert.flax_last_dim(full_model, n)]
            for n, p in params.items()}
    tree = {n: jnp.zeros((1,) * (p.dim() - 1) + (last[n],), jnp.float32)
            for n, p in params.items()}
    placed = jax_mesh.shard_params_tp(tree, jax_mesh.make_mesh_2d(data,
                                                                  model))
    want = {n: x.sharding.shard_shape(x.shape)[-1] for n, x in placed.items()
            if tuple(x.sharding.spec)[-1:] == ("model",)}
    plan = mesh.tp_plan(full_model, model)
    assert sorted(plan) == sorted(want)
    assert len(plan) == {2: 109, 4: 108}[model]
    for n, d in plan.items():
        assert d == convert.flax_last_dim(full_model, n)
        assert params[n].shape[d] // model == want[n], n
    assert sum(p.numel() // model if n in plan else p.numel()
               for n, p in params.items()) == held


def test_make_mesh_2d_refuses_other_world_sizes(monkeypatch):
    """Fewer ranks than ``data * model``: JAX's message; more: refused by
    name (a rank outside the mesh has no part in a step)."""
    import jax

    from pdfnet_tpu.parallel import mesh as jax_mesh
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh_2d(2, 2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        mesh.make_mesh_2d(2, 2)
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(mesh, "process_count", lambda: 8)
    with pytest.raises(ValueError, match="covers 4 of the 8 processes"):
        mesh.make_mesh_2d(2, 2)


@pytest.mark.parametrize("what", ["zero1", "csp", "trainer", "cli"])
def test_refused_under_a_model_axis(what, monkeypatch, tmp_path):
    """What the 2-D layout does not take raises a ValueError by name under
    a model axis > 1: ZeRO-1 (JAX's ``zero1_state_shardings`` pins the
    parameters replicated), the CSP detector's step, ``Trainer`` and
    ``cli.main`` (JAX's trainer has no 2-D path)."""
    layout = mesh.Layout(1, 2, 0, 0)
    monkeypatch.setattr(mesh, "current_mesh", lambda: layout)
    cfg = port.Config(**SMALL)
    with pytest.raises(ValueError, match="model axis of 2"):
        if what == "zero1":
            port.create_train_state(cfg.replace(zero1_opt_sharding=True),
                                    port.HandNet(cfg))
        elif what == "csp":
            from pdfnet_tpu_torch.models.csp import csp_from_config
            from pdfnet_tpu_torch.train.step import make_csp_train_step
            ccfg = cfg.replace(arch="csp_18")
            make_csp_train_step(ccfg, csp_from_config(ccfg), None)
        elif what == "trainer":
            from pdfnet_tpu_torch.train.trainer import Trainer
            Trainer(cfg, device="cpu")
        else:
            from pdfnet_tpu_torch.cli.main import main
            main(["--cpu", "--synthetic", "--mode", "train",
                  "--output_path", str(tmp_path)])


# ---- over four ranks ----------------------------------------------------------

def test_2d_layout_over_four_ranks():
    """Every check over ranks in one group of four gloo ranks, (2 x 2),
    spawned once by this one test (a module fixture would be spawned again
    by every test worker the scheduler sends one of its tests to), in
    order: the split modules in float64, the cuts of live BatchNorm in
    float64, the train step, the two cuts, the eval and the serving steps
    (each below)."""
    parts = [("float64 split modules", split_modules_are_exact_in_float64),
             ("float64 cuts", cuts_are_exact_in_float64),
             ("train step", train_step_matches_one_process)]
    parts += [(what, lambda g, w=what: cuts_match_one_process(w, g))
              for what in ("bn_stat_groups", "grad_accum_steps")]
    parts += [(label, lambda g, s=serve: eval_and_serving_match_one_process(
        s, g)) for label, serve in (("eval step", False),
                                    ("serving step", True))]
    ranks4 = RankGroup(4)
    try:
        for label, part in parts:
            try:
                part(ranks4)
            except AssertionError as e:
                raise AssertionError(f"{label}: {e}") from e
    finally:
        ranks4.close()


def split_modules_are_exact_in_float64(ranks4):
    """Each module kind the plan splits, column-parallel over the model
    axis of the (2 x 2) layout (an embedding read whole), in float64: the
    output, the input's gradient and every parameter's gradient equal the
    unsplit module's to 1e-12 on every rank."""
    for gaps in ranks4.run(column_parallel_gaps, MESH):
        assert len(gaps) == 6
        for kind, gap in gaps.items():
            assert gap <= 1e-12, (kind, gap)


def cuts_are_exact_in_float64(ranks4):
    """The cut repair with live BatchNorm in float64 (``conv_act_bn_cuts``,
    ``test_torch_parallel.assert_f64_cuts_match``), three BatchNorm groups
    and three accumulation chunks each: over the four ranks as data ranks,
    a batch of 12 whose cuts fall 3 + 1, 2 + 2 and 1 + 3 rows on pairs of
    ranks (uneven counts; each rank in two cuts' groups); and on the
    (2 x 2) layout, a batch of 6 whose middle cut splits the two data
    ranks of each model index (a group a model index), the convolution
    split column-parallel over the model axis (256 output channels)."""
    rng = np.random.RandomState(4)
    for x, weights, mesh_2d in (
            (rng.randn(12, 10, 10, 16), conv_act_bn_weights(32, 3), None),
            (rng.randn(6, 10, 10, 16), conv_act_bn_weights(256, 1), MESH)):
        for what in ("bn_stat_groups", "grad_accum_steps"):
            ranks = ranks4.run(conv_act_bn_cuts, weights, x, what, 3,
                               mesh_2d)
            want = conv_act_bn_cuts(weights, x, what, 3)
            assert_f64_cuts_match(ranks, want, 1 if mesh_2d is None else 2)


def train_step_matches_one_process(ranks4):
    """One step on the (2 x 2) layout against one process on the same
    global batch of 4, frozen BatchNorm, dropout on (each step's masks
    from a generator seeded alike on every rank: the data ranks keep their
    rows of the global batch's mask): loss terms, the gathered gradients
    and parameters within ``assert_near_one_process`` (2.7e-5 of the
    gradient vector against 1e-3); every rank's stored
    split parameter holds 1/2 of the planned dim, its Adam moments the
    slice's shape, ``gather_to_host`` the one-process moment shapes in the
    one-process order; the four ranks end bit for bit alike (digests of
    the gathered parameters and the statistics) with equal loss stats:
    the model peers of each data rank computed the same replicated
    values."""
    cfg = dict(SMALL, freeze_bn_stats=True, dropout=0.1)
    batch = port.make_batch(port.Config(**cfg), 4, seed=0)
    ranks4.start(train_steps, cfg, 1, batch, 1, 30, 1e-4, None, MESH, 5)
    try:
        want = train_steps(cfg, 1, batch, seed=5)
    finally:
        ranks = ranks4.wait()
    assert len({r["digest"] for r in ranks}) == 1
    # the loss stats come from before the peers' replicated gradients are
    # averaged (``mesh.sync_model_peers``): equal, the peers computed alike
    assert all(r["stats"] == ranks[0]["stats"] for r in ranks)
    assert [r["step"] for r in ranks] == [1] * 4
    assert_near_one_process(ranks[0], want, GRAD_RTOL["handnet"])
    model = port.HandNet(port.Config(**cfg))
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    plan = mesh.tp_plan(model, 2)
    assert ranks[0]["plan"] == plan and len(plan) == 109
    for r in ranks:
        for n, shape in full.items():
            if n in plan:
                d = plan[n]
                shape = shape[:d] + (shape[d] // 2,) + shape[d + 1:]
            assert r["stored"][n] == shape, n
        order = list(r["stored"])
        for i, m in r["moments"].items():
            assert m == r["stored"][order[i]]
        assert r["host_moments"] == want["moments"]


def cuts_match_one_process(what, ranks4):
    """``bn_stat_groups=2`` / ``grad_accum_steps=2`` on the (2 x 2) layout,
    frozen BatchNorm, global batch 4: each data rank's two rows are one
    cut, run on its model peers alike.  Loss terms, gradients and
    parameters against one process within ``assert_near_one_process``;
    the ranks bit for bit alike.  Live statistics over the layout's cuts:
    ``cuts_are_exact_in_float64``."""
    cfg = dict(SMALL, freeze_bn_stats=True, **{what: 2})
    batch = port.make_batch(port.Config(**cfg), 4, seed=0)
    ranks4.start(train_steps, cfg, 1, batch, 1, 30, 1e-4, None, MESH)
    try:
        want = train_steps(cfg, 1, batch)
    finally:
        ranks = ranks4.wait()
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["stats"] == ranks[0]["stats"] for r in ranks)
    assert_near_one_process(ranks[0], want, GRAD_RTOL["handnet"])


def _split_masks(weights, cfg, img):
    """Shift the mask head's bias so that each hand's predicted mask covers
    about half the image with 0.5 in the widest gap of its middle 40 %
    (``tests/test_torch_infer.py``'s rule, on the port's one process): a
    mask value near 0.5 could flip between float32 orders."""
    model = port.HandNet(port.Config(**cfg)).eval()
    model.load_state_dict(weights)
    with torch.inference_mode():
        mask = model.encoder.image_phase(
            torch.from_numpy(img).permute(0, 3, 1, 2), aux=False,
            need_mask=True)[1]
    bias = weights["encoder.dp_decoder.head.bias"].clone()
    for c in range(mask.shape[1]):
        vals = np.sort(mask[:, c].numpy().ravel())
        lo, hi = int(0.3 * vals.size), int(0.7 * vals.size)
        i = lo + int(np.argmax(np.diff(vals[lo:hi])))
        bias[c] += 0.5 - (vals[i] + vals[i + 1]) / 2
    return bias


def eval_and_serving_match_one_process(serve, ranks4):
    """The batched eval step (``make_eval_step``, ``pallas_sa``: the
    level-2 MLP fold reads the gathered ``mlp2.fc2``) and the serving step
    (``infer_rgbd`` + ``eval_outputs``, ``knn_method="pallas"``,
    ``fused_trunk``: the bottleneck folds read gathered weights;
    deterministic clouds) on the (2 x 2) layout, a global batch of 4,
    against one process: each data rank's outputs are its rows of one
    process's within ``EVAL_TOL``, its two model peers' bit for bit
    alike."""
    from test_torch_eval_step import _batch
    cfg = dict(SMALL)
    if serve:
        cfg.update(knn_method="pallas", fused_trunk=True,
                   sample_deterministic=True)
    batch = _batch(4, cfg["default_resolution"], cfg["sample_num"])
    model = port.HandNet(port.Config(**cfg))
    weights = seeded_state(model, 1)
    over = {}
    if serve:
        over["encoder.dp_decoder.head.bias"] = _split_masks(
            weights, cfg, batch["input"]).numpy()
    ranks4.start(eval_outputs_of, cfg, (1, over), batch, serve, MESH)
    try:
        want = eval_outputs_of(cfg, (1, over), batch, serve)
    finally:
        ranks = ranks4.wait()
    assert sorted(ranks[0]) == sorted(want)
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        for k, v in want.items():
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            rows = slice(2 * d, 2 * d + 2) if v.ndim and v.shape[0] == 4 \
                else slice(None)
            assert np.isfinite(a[k]).all(), k
            np.testing.assert_allclose(a[k], v[rows], err_msg=k, **EVAL_TOL)
