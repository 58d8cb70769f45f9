"""The port's train step against the JAX one.

Both packages start from the same seeded random weights (every flax leaf
drawn with numpy, carried across by ``convert.from_flax``) on the same
synthetic batch at a small float32 config, with ``dropout=0``.  The JAX side
takes its fused grouping branches with the Pallas kernels in interpret mode
and makes its update as ``make_train_step`` does (``jax.grad`` of
``compute_loss`` over ``model.apply(train=True)``, then the
``inject_hyperparams(adam)`` update at the step's learning rate); one
``jax.jit`` of the gradient serves all three steps.

- frozen BatchNorm (``freeze_bn_stats=True``): every loss term within 2e-4
  (the eval step's bar, ``tests/test_torch_eval_step.py``: the same forward
  through ResNet-50 summed in another order), and every gradient leaf by
  leaf within 1e-2 of the leaf's norm (``GRAD_RTOL``,
  ``_assert_grads_close``), with ``tests/test_grad_accum.py``'s exclusion
  of the attention key biases.  ``test_grad_accum.py``'s elementwise bar
  (1e-5 of the leaf's largest entry, 1e-4 relative) holds for the jitted
  JAX step against itself, whose per-sample arithmetic does not depend on
  the batch size; another float32 evaluation order (eager JAX, the port,
  the port at another batch size or thread count) moves some leaves of
  this randomly weighted model by up to 3.5e-3;
- a 3-step loss trajectory within 1e-3: Adam's first steps move each
  parameter by about ``lr * sign(g)``, so a near-zero gradient entry whose
  sign float32 noise flips moves 2 * lr the other way, and at random
  weights the loss falls fivefold in those steps;
- live BatchNorm: one train-mode call of ``PointMLP`` and ``ConvActBN``
  against flax's ``batch_stats`` update (the whole model at random init
  amplifies float32 noise through live statistics);
- ``grad_accum_steps=2`` against one shot, ``bn_stat_groups=2`` against its
  per-group definition, ``skip_nonfinite_updates`` with a NaN batch, and
  ``lr_at_epoch``, on the port alone where the JAX step only defines the
  semantics (with the port's own seeded weights: no JAX compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import build_model as jax_build_model
from pdfnet_tpu.models.layers import ConvActBN as JaxConvActBN
from pdfnet_tpu.models.pointnet import PointMLP as JaxPointMLP
from pdfnet_tpu.ops import grouping, pallas_knn
from pdfnet_tpu.train.loss import compute_loss as jax_compute_loss
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts
from pdfnet_tpu.train.step import lr_at_epoch as jax_lr_at_epoch
from pdfnet_tpu.train.step import make_optimizer

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.models.layers import BatchNorm, ConvActBN, Dropout
from pdfnet_tpu_torch.models.pointnet import PointMLP
from pdfnet_tpu_torch.ops import grouping as port_grouping
from pdfnet_tpu_torch.ops import sa
from pdfnet_tpu_torch.ops.sa import knn_plain as sa_knn_plain

from test_torch_eval_step import _random_like, jax_variables
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8,
             batch_size=2, dropout=0.0, freeze_bn_stats=True)
EPOCH, LR, STEPS = 30, 1e-4, 3
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-3)
# Per leaf, relative to the leaf's norm: about three times the float32
# spread of the gradient under another evaluation order alone, which
# reaches 3.5e-3 (``python tests/test_torch_train_step.py`` prints it): the
# port against itself with one and with eight CPU threads differs by that
# much on the last ResNet stage's BatchNorm gradients; the JAX step's jitted
# and eager gradients differ by 1.1e-3 on the level-1 PointNet++ weights,
# whose gradient sums thousands of cancelling products with centered xyz.
GRAD_RTOL = 1e-2


def _batch(seed=0):
    return port.make_batch(port.Config(**SMALL), 2, seed=seed)


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights and a batch for the tests of the port alone."""
    return _port_state(), _batch()


def _port_state(seed=1):
    """The port's HandNet weights with flax's initializers, then, as
    ``jax_variables`` draws them, every bias, norm gain and BatchNorm
    statistic random, and hand-sized vertex offsets (see ``run_jax``)."""
    model = port.build_model(port.Config(**SMALL), device="cpu")
    rng = np.random.RandomState(seed)
    norms = {n for n, m in model.named_modules()
             if isinstance(m, (BatchNorm, torch.nn.LayerNorm))}
    state = model.state_dict()
    with torch.no_grad():
        for name, t in state.items():
            owner, leaf = name.rsplit(".", 1)
            if leaf == "running_var":
                t.copy_(_t(rng.uniform(0.5, 2.0, t.shape)))
            elif leaf in ("bias", "running_mean"):
                t.copy_(_t(rng.uniform(-0.3, 0.3, t.shape)))
            elif leaf == "weight" and owner in norms:
                t.copy_(_t(1.0 + rng.uniform(-0.3, 0.3, t.shape)))
            if owner == "decoder.coord_head":
                t.mul_(0.01)
    return state


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _recording(fn, pick, log):
    """``fn`` (a JAX grouping kernel's entry point), also sending each
    call's (d2 or validity, idx) to ``log`` from inside the jitted step."""
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(lambda *a: log.append(tuple(map(np.asarray, a))),
                           *pick(out), ordered=True)
        return out
    return run


def jit_update(tx):
    """``tx.update`` then ``optax.apply_updates``, as the JAX train step
    makes its update, under one ``jax.jit``: run eagerly, the update
    dispatches and compiles each leaf's ops on their own (~40 s a step on
    the CPU)."""
    def update(grads, opt, params):
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt
    return jax.jit(update)


def run_jax():
    """JAX: variables, the batch, the first step's stats and gradients, the
    loss of each of STEPS steps, and every grouping call's selection."""
    cfg = JaxConfig(**SMALL)
    batch = _batch()
    variables = jax_variables(cfg, batch)
    # hand-sized vertex offsets (~5 cm): at full scale the random decoder
    # puts joints near the camera plane, where the 2-D terms blow up
    head = variables["params"]["decoder"]["coord_head"]
    head.update({k: v * np.float32(0.01) for k, v in head.items()})
    model, consts, tx = jax_build_model(cfg), jax_consts(), make_optimizer(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, b):
        (result, p_dict, hd, other), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            b["input"], b["choose"], b["cloud"], b["depth"], b["ind"],
            b["K_new"], b["valid"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jax_compute_loss(cfg, consts, result, p_dict, hd, other, b,
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
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        update = jit_update(tx)
        params, opt = variables["params"], jax.jit(tx.init)(variables["params"])
        losses, first = [], None
        for _ in range(STEPS):
            (loss, stats), grads = grad_fn(params, jb)
            first = first or (jax.tree.map(np.asarray, stats),
                              jax.tree.map(np.asarray, grads))
            losses.append(float(loss))
            opt.hyperparams["learning_rate"] = jnp.asarray(LR, jnp.float32)
            params, opt = update(grads, opt, params)
        jax.effects_barrier()
    finally:
        (grouping._FUSED_INTERPRET, pallas_knn.knn_gather_xyz_pallas,
         pallas_knn.group_feat_pallas) = saved
    assert len(selections) == 2 * STEPS
    return variables, batch, first[0], first[1], losses, selections


def _port_model(weights, **overrides):
    """A port HandNet in training mode at SMALL (+ overrides), with flax
    variables or a port state_dict as its weights."""
    cfg = port.Config(**{**SMALL, **overrides})
    model = port.HandNet(cfg)
    if "params" in weights:
        weights = convert.from_flax(weights, model)
    model.load_state_dict(weights)
    return cfg, model.train()


def run_port(variables, batch, selections=None):
    """The port: the first step's stats and gradients, each step's loss.

    With ``selections`` (the JAX step's, in call order) the plain grouping
    takes JAX's neighbours: the two sides compute the clouds' float32 xyz in
    other summation orders, and a neighbour on a near-tie or on the ball's
    radius can then be picked on one side only, which moves its gradient to
    another point (about 1e-3 of the level-1 weights' gradient for one such
    neighbour).  The selection itself is compared bit for bit in
    tests/test_torch_grouping.py; the number of slots where the port's own
    selection differs is returned."""
    replay, flips = list(selections or []), [0]

    def knn_plain(xyz, num_centers, k):
        dist, idx = sa_knn_plain(xyz, num_centers, k)
        if not selections:
            return dist, idx
        ref, ref_idx = replay.pop(0)
        ref_idx = torch.from_numpy(ref_idx.astype(np.int64))
        flips[0] += int((idx != ref_idx).sum())
        if ref.dtype == np.bool_:   # group_feat_pallas returns validity
            ref = np.where(ref, np.float32(0), np.float32(np.inf))
        return torch.from_numpy(np.array(ref)), ref_idx

    cfg, model = _port_model(variables)
    state = port.create_train_state(cfg, model)
    step = port.make_train_step(cfg, model, port.load_loss_consts("cpu"))
    losses, first = [], None
    saved = (port_grouping.knn_plain, sa.knn_plain)
    port_grouping.knn_plain = sa.knn_plain = knn_plain
    try:
        for _ in range(STEPS):
            stats = step(state, batch, EPOCH, LR)
            if first is None:
                grads = {n: (p.grad.clone() if p.grad is not None
                             else torch.zeros_like(p))
                         for n, p in model.named_parameters()}
                first = ({k: v.numpy() for k, v in stats.items()}, grads)
            losses.append(float(stats["loss"]))
    finally:
        port_grouping.knn_plain, sa.knn_plain = saved
    assert not replay
    return model, first[0], first[1], losses, state, flips[0]


def _assert_grads_close(got, want, names):
    """Leaf by leaf, ||got - want|| <= GRAD_RTOL ||want||, skipping the
    attention key biases, whose gradient cancels in the softmax:
    analytically zero, in float32 noise (the exclusion of
    tests/test_grad_accum.py)."""
    checked = 0
    for name in names:
        if name.endswith("wk.bias"):
            continue
        a, b = want[name].double(), got[name].double()
        err = float((b - a).norm()) / max(float(a.norm()), 1e-30)
        assert err <= GRAD_RTOL, f"gradient of {name}: relative error {err:.3e}"
        checked += 1
    return checked


def test_train_step_matches_jax():
    """Frozen BN: every loss term of the first step, every gradient leaf,
    and the loss of each of STEPS steps.  One test, so that one process
    makes the JAX reference (one compile of the gradient)."""
    jr = run_jax()
    model, stats_t, grads_t, losses_t, state, _ = run_port(
        *jr[:2], selections=jr[5])
    assert sorted(stats_t) == sorted(jr[2])
    for k in jr[2]:
        np.testing.assert_allclose(stats_t[k], jr[2][k], err_msg=k,
                                   **LOSS_TOL)
    grads_j = convert.params_from_flax(jr[3], model)
    assert _assert_grads_close(grads_t, grads_j, sorted(grads_t)) >= \
        0.9 * len(grads_t)
    assert np.isfinite(losses_t).all() and losses_t[-1] < losses_t[0]
    np.testing.assert_allclose(losses_t, jr[4], **TRAJ_TOL)
    assert state.step == STEPS


def test_frozen_bn_statistics_stay(weights):
    """``freeze_bn_stats``: train-time normalization with the running
    statistics, which the step leaves as they were (and the scale and bias
    train)."""
    cfg, model = _port_model(weights[0])
    step = port.make_train_step(cfg, model, port.load_loss_consts("cpu"))
    step(port.create_train_state(cfg, model), weights[1], EPOCH, LR)
    moved = 0
    for n, b in model.state_dict().items():
        if "running" in n:
            torch.testing.assert_close(b, weights[0][n], rtol=0, atol=0)
        elif n.endswith("bn0.weight"):
            moved += bool((b != weights[0][n]).any())
    assert moved > 0


# ---- live BatchNorm against flax's update ----------------------------------

def _live_bn_pair(jax_module, port_module, x, seed, nchw=False):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0),
                                                    x, False))
    rng = np.random.RandomState(seed)
    variables = {c: _random_like(shapes[c], rng)
                 for c in ("params", "batch_stats")}
    y_j, mutated = jax_module.apply(variables, x, True,
                                    mutable=["batch_stats"])
    port_module.load_state_dict(convert.from_flax(variables, port_module))
    y_t = port_module.train()(torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2)) if nchw else x))
    return (np.asarray(y_j), y_t.detach().numpy(), mutated["batch_stats"],
            port_module)


def _assert_running_stats(bs_j, module):
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm):
            ref = bs_j
            for part in name.split("."):
                ref = ref[part]
            np.testing.assert_allclose(m.running_mean.numpy(), ref["mean"],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(m.running_var.numpy(), ref["var"],
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_point_mlp_live_bn_matches_flax():
    x = np.random.RandomState(0).randn(4, 32, 8, 131).astype(np.float32)
    y_j, y_t, bs_j, module = _live_bn_pair(
        JaxPointMLP((128, 128, 256)), PointMLP(131, (128, 128, 256)), x, 1)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-5)
    _assert_running_stats(bs_j, module)


def test_conv_act_bn_live_bn_matches_flax():
    x = np.random.RandomState(2).randn(2, 12, 12, 16).astype(np.float32)
    y_j, y_t, bs_j, module = _live_bn_pair(
        JaxConvActBN(32, kernel=3), ConvActBN(16, 32, 3), x, 3, nchw=True)
    np.testing.assert_allclose(y_t.transpose(0, 2, 3, 1), y_j, rtol=1e-4,
                               atol=1e-5)
    _assert_running_stats(bs_j, module)


def test_live_bn_uses_biased_variance_and_flax_momentum():
    """flax updates the running variance with the biased batch variance
    at momentum 0.9; ``torch.nn.BatchNorm`` would use the unbiased one."""
    m = BatchNorm(3).train()
    x = torch.randn(5, 3, 4, generator=torch.Generator().manual_seed(0))
    m(x)
    var = x.permute(1, 0, 2).reshape(3, -1).var(dim=1, unbiased=False)
    torch.testing.assert_close(m.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(m.running_mean,
                               0.1 * x.mean(dim=(0, 2)))


def test_dropout_is_flax_dropout():
    """Kept with probability 1 - p and scaled by 1 / (1 - p) at train time,
    drawn from the generator it is given; the identity at eval."""
    d = Dropout(0.25).train()
    x = torch.ones(40000)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    assert set(y.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.01
    d.generator = torch.Generator().manual_seed(0)
    torch.testing.assert_close(d(x), y, rtol=0, atol=0)
    assert d.eval()(x) is x and Dropout(0.0).train()(x) is x


# ---- step options ------------------------------------------------------------

def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def test_grad_accum_matches_one_shot(weights):
    """Frozen BN: the mean of the two chunks' gradients is the full batch's
    gradient (test_grad_accum.py's bar)."""
    runs = []
    for accum in (1, 2):
        cfg, model = _port_model(weights[0], grad_accum_steps=accum)
        step = port.make_train_step(cfg, model, port.load_loss_consts("cpu"))
        stats = step(port.create_train_state(cfg, model), weights[1], EPOCH,
                     LR)
        runs.append((float(stats["loss"]), _grads(model)))
    (loss1, g1), (loss2, g2) = runs
    np.testing.assert_allclose(loss2, loss1, rtol=1e-6)
    assert sorted(g1) == sorted(g2)
    assert _assert_grads_close(g2, g1, sorted(g1)) >= 0.9 * len(g1)


def test_step_option_errors(weights):
    cfg, model = _port_model(weights[0], grad_accum_steps=2, bn_stat_groups=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        port.make_train_step(cfg, model, None)
    cfg, model = _port_model(weights[0], grad_accum_steps=2)
    step = port.make_train_step(cfg, model, port.load_loss_consts("cpu"))
    odd = {k: v[:1] for k, v in weights[1].items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps"):
        step(port.create_train_state(cfg, model), odd, EPOCH, LR)


def test_bn_stat_groups_normalize_per_group(weights):
    """Live BN with ``bn_stat_groups=2``: the loss is the mean of the two
    groups' losses, each group normalizes with its own half from the same
    running statistics, and group 0's new statistics are kept."""
    batch = weights[1]
    halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
    consts = port.load_loss_consts("cpu")
    cfg, model = _port_model(weights[0], freeze_bn_stats=False,
                             bn_stat_groups=2)
    stats = port.make_train_step(cfg, model, consts)(
        port.create_train_state(cfg, model), batch, EPOCH, LR)
    kept = {n: b for n, b in model.named_buffers() if "running" in n}

    losses = []
    for i, half in enumerate(halves):
        cfg1, ref = _port_model(weights[0], freeze_bn_stats=False)
        with torch.no_grad():
            b = {k: torch.from_numpy(v) for k, v in half.items()}
            out = ref(b["input"], b["choose"], b["cloud"], ind=b["ind"])
            losses.append(float(port.compute_loss(cfg1, consts, *out, b,
                                                  EPOCH)[0]))
        if i == 0:
            for n, buf in ref.named_buffers():
                if "running" in n:
                    torch.testing.assert_close(kept[n], buf, rtol=0, atol=0)
    np.testing.assert_allclose(float(stats["loss"]), np.mean(losses),
                               rtol=1e-6)


def test_skip_nonfinite_leaves_state_unchanged(weights):
    cfg, model = _port_model(weights[0], freeze_bn_stats=False,
                             skip_nonfinite_updates=True)
    state = port.create_train_state(cfg, model)
    step = port.make_train_step(cfg, model, port.load_loss_consts("cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = {k: v.copy() for k, v in weights[1].items()}
    bad["input"][0, 0, 0, 0] = np.nan
    stats = step(state, bad, EPOCH, LR)
    assert float(stats["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(stats["loss"]))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)
    for p in model.parameters():
        for v in state.optimizer.state.get(p, {}).values():
            assert not torch.is_tensor(v) or not v.any()
    assert state.step == 1
    stats = step(state, weights[1], EPOCH, LR)
    assert float(stats["skipped_nonfinite"]) == 0.0
    assert any((p != before[n]).any() for n, p in model.named_parameters())


@pytest.mark.parametrize("epoch", [0, 29, 30, 80])
def test_lr_at_epoch_matches_jax(epoch):
    for lr_step in ((30,), (10, 30)):
        cfg_t = port.Config(lr=1e-4, lr_step=lr_step)
        cfg_j = JaxConfig(lr=1e-4, lr_step=lr_step)
        assert port.lr_at_epoch(cfg_t, epoch) == jax_lr_at_epoch(cfg_j, epoch)


def test_create_train_state_uses_optax_adam_defaults():
    model = torch.nn.Linear(2, 2)
    state = port.create_train_state(port.Config(lr=3e-4), model)
    group = state.optimizer.param_groups[0]
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["lr"] == 3e-4 and group["weight_decay"] == 0
    assert state.step == 0


def _spread(a, b):
    """{leaf: ||a - b|| / ||b||} for two gradient dicts of the port's
    names, without the attention key biases."""
    return {n: float((a[n].double() - b[n].double()).norm())
            / max(float(b[n].double().norm()), 1e-30)
            for n in b if not n.endswith("wk.bias")}


if __name__ == "__main__":
    # The float32 spread behind GRAD_RTOL: the same gradients under other
    # evaluation orders, on this file's input (about two minutes on a CPU).
    jr = run_jax()
    variables, batch = jr[:2]
    cfg, model = JaxConfig(**SMALL), jax_build_model(JaxConfig(**SMALL))
    consts, jb = jax_consts(), {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        (result, p_dict, hd, other), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb["input"], jb["choose"], jb["cloud"], jb["depth"], jb["ind"],
            jb["K_new"], jb["valid"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jax_compute_loss(cfg, consts, result, p_dict, hd, other, jb,
                                jnp.asarray(EPOCH), mode="train")[0]

    grouping._FUSED_INTERPRET = True
    _, probe = _port_model(variables)
    eager = convert.params_from_flax(jax.grad(loss)(variables["params"]),
                                     probe)
    jitted = convert.params_from_flax(jr[3], probe)
    runs = []
    for accum, threads in ((1, 8), (2, 8), (1, 1)):
        torch.set_num_threads(threads)
        c, m = _port_model(variables, grad_accum_steps=accum)
        port.make_train_step(c, m, port.load_loss_consts("cpu"))(
            port.create_train_state(c, m), batch, EPOCH, LR)
        runs.append(_grads(m))
    for what, spread in (("JAX jitted vs eager", _spread(jitted, eager)),
                         ("port two chunks vs one shot",
                          _spread(runs[1], runs[0])),
                         ("port one thread vs eight",
                          _spread(runs[2], runs[0]))):
        top = sorted(spread, key=spread.get, reverse=True)[:5]
        print(f"{what}: " + ", ".join(f"{n} {spread[n]:.2e}" for n in top))
