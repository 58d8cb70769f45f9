"""Multi-process data parallelism of the port (``parallel/mesh.py`` on
``torch.distributed``) on the CPU, over two gloo ranks (``rank_group``,
``tests/test_torch_ranks.py``), against one process on the same global
batch and weights, and ``mesh.py``'s functions against the JAX package's.

Each rank takes its stripe of the global batch (rank 0's rows first).
Bounds of the step against one process (``_assert_matches``): loss terms
within 1e-5 relative, gradients within ``GRAD_RTOL`` of each leaf's norm,
running statistics within 1e-5, updated parameters within 1e-3 lr plus 2
float32 spacings and with the one-process update's sign wherever its
gradient exceeds 1e-3 of the leaf's largest entry (the rule of
``tests/test_torch_csp.py``).  Only the order of float32 sums differs
between the two sides (the ranks' partial sums, convolutions at batch 1
against batch 2).  With the HandNet's live BatchNorm at random weights that
order alone moves a loss term by up to 3.5e-5 in one process (one thread
against four: the mask decoder's term), so the HandNet cases that are not
about BatchNorm run with frozen statistics; the BatchNorm groups, the
accumulation chunks, the CSP detector (``feat_bn`` at momentum 0.99) and
``ConvActBN`` (``tests/test_torch_train_step.py``) train them live.

A cut that splits a rank (``_rank_cuts``: three BatchNorm groups or
accumulation chunks of a batch of 6 over two ranks) runs its middle cut
at batch 1 on each rank against batch 2 in one process, and this batch
amplifies that float32 order: with frozen statistics one process itself
moves by 1.1e-4 of its gradient vector and 1.4e-2 of ``e_conv1``'s
gradient (feeding the cancelling level-0 SFT) between one and two torch
threads; the two ranks lie 2.0e-4 and 1.5e-2 from it (loss terms
1.6e-7).  So the HandNet's split cuts run with frozen statistics and are
held by ``assert_near_one_process`` (the gradients as one vector within
``GRAD_RTOL["handnet"]``, each leaf within ``MOMENT_RTOL``), and live
BatchNorm over split cuts is held in float64
(``test_split_cuts_match_one_process_in_float64``), where no order
amplifies: forward, gradients and the chained running statistics within
``F64_RTOL``.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch.parallel import mesh

from test_torch_ranks import (SMALL, checkpoint_round_trip,
                              conv_act_bn_cuts, conv_act_bn_weights, fit_run,
                              hard_example_mining_grad, merged_metrics,
                              rank_group, train_steps)  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401

LR = 1e-4
LOSS_RTOL = 1e-5
BN_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_RTOL = 1e-3
ADAM_GRAD_FLOOR = 1e-3
# of each leaf's norm; the frozen HandNet's 2-rank gradients lie up to
# 3.1e-4 from one process's (the mesh decoder's GCN norms: per-rank sums
# of thousands of products), below the 3.5e-3 that one process moves by
# at another thread count (tests/test_torch_train_step.py)
GRAD_RTOL = {"handnet": 1e-3, "bn_stat_groups": 1e-4,
             "grad_accum_steps": 1e-4, "csp_18": 1e-4}


# the float64 ConvActBN over split cuts against one process: the
# outputs, gradients and running statistics (largest seen 1.9e-12 of a
# gradient's norm), the loss within 1e-6 (``all_reduce_stats`` averages
# the stats in float32: 3.4e-8 seen)
F64_RTOL = 1e-10
F64_LOSS_RTOL = 1e-6


def _batch(cfg_kw, seed=0, size=2):
    return port.make_batch(port.Config(**cfg_kw), size, seed=seed)


def _vector_gap(a: dict, b: dict, names) -> float:
    num = sum(float(np.sum((a[n] - b[n]) ** 2)) for n in names)
    den = sum(float(np.sum(b[n] ** 2)) for n in names)
    return (num / max(den, 1e-60)) ** 0.5


def _leaf_gap(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_near_one_process(got, want, grad_rtol, lr=LR):
    """A rank-0 result of ``train_steps`` against the one-process one
    where the ranks change float32 orders that the model amplifies (a cut
    that splits a rank, a split matmul): every loss term within 1e-5
    relative, the gradients as one vector within ``grad_rtol`` of its
    norm and each leaf within ``MOMENT_RTOL`` (``CANCELLING`` left out,
    as ``chip_smoke.py`` phase 14 holds them), every running statistic
    within ``BN_TOL``, and the update on the entries whose gradient stands
    above 1e-3 of its leaf's largest and agrees within 1e-4 on both sides
    (``_assert_checkpoints_match``'s rule)."""
    for s_got, s_want in zip(got["stats"], want["stats"]):
        assert sorted(s_got) == sorted(s_want)
        for k, v in s_want.items():
            gap = abs(s_got[k] - v) / max(abs(v), 1e-12)
            assert gap <= LOSS_RTOL, f"{k}: {gap:.3e}"
    names = [n for n in want["grads"] if not any(c in n for c in CANCELLING)]
    gap = _vector_gap(got["grads"], want["grads"], names)
    assert gap <= grad_rtol, f"gradients: {gap:.3e} of their norm"
    for n in names:
        gap = _leaf_gap(got["grads"][n], want["grads"][n])
        assert gap <= MOMENT_RTOL, f"gradient of {n}: {gap:.3e}"
    for n, b in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n], b, err_msg=n, **BN_TOL)
    n_held = n_all = 0
    for n, p in want["params"].items():
        if any(c in n for c in CANCELLING):
            continue
        g, g_got = want["grads"][n], got["grads"][n]
        held = ((np.abs(g) > ADAM_GRAD_FLOOR * np.abs(g).max())
                & (np.abs(g_got - g) < 1e-4 * np.abs(g)))
        move = np.abs(got["params"][n] - p)[held]
        assert (move <= ADAM_RTOL * lr
                + 2 * np.spacing(np.abs(p))[held]).all(), f"update of {n}"
        n_held += int(held.sum())
        n_all += p.size
    assert n_held > n_all / 50, (n_held, n_all)


def _assert_matches(got, want, grad_rtol, steps=1, lr=LR):
    """A rank-0 result of ``train_steps`` against the one-process one."""
    for s_got, s_want in zip(got["stats"], want["stats"]):
        assert sorted(s_got) == sorted(s_want)
        for k in s_want:
            np.testing.assert_allclose(s_got[k], s_want[k], rtol=LOSS_RTOL,
                                       atol=1e-12, err_msg=k)
    for n, g in want["grads"].items():
        if n.endswith("wk.bias"):
            # the attention key biases cancel in the softmax: their
            # gradient is float32 noise (tests/test_grad_accum.py)
            continue
        err = np.linalg.norm(got["grads"][n] - g) / max(np.linalg.norm(g),
                                                        1e-30)
        assert err <= grad_rtol, f"gradient of {n}: {err:.3e} of its norm"
    for n, b in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n], b, err_msg=n, **BN_TOL)
    n_held = n_all = 0
    for n, p in want["params"].items():
        if n.endswith("wk.bias"):
            continue
        g = want["grads"][n]
        held = (np.abs(g) > ADAM_GRAD_FLOOR * np.abs(g).max()) & (
            np.abs(g) > 1e-5)
        q = got["params"][n]
        assert (np.abs(q - p)[held] <= steps * ADAM_RTOL * lr
                + 2 * np.spacing(np.abs(p))[held]).all(), f"update of {n}"
        n_held += int(held.sum())
        n_all += p.size
    assert n_held > n_all / 2, (n_held, n_all)


@pytest.mark.parametrize("case", ["quirks", "bn_stat_groups",
                                  "grad_accum_steps", "csp_18",
                                  "bn_stat_groups=3", "grad_accum_steps=3"])
def test_two_ranks_match_one_process(case, rank_group):
    """One step on two ranks against one process on the same global batch
    of 2.  ``quirks``: ``replicate_reference_quirks`` (the focal loss's
    batch-global guard) with rank 1's sample stripped of positives and of
    its right hand (``valid``), so a per-rank guard or ``reg_l1_loss``
    count would differ from the global one; ``bn_stat_groups``: two
    BatchNorm groups, one a rank, live; ``grad_accum_steps``: two chunks,
    one a rank, live (the running statistics chained over both);
    ``csp_18``: the CSP detector's step, live, its focal guard always
    global.  ``bn_stat_groups=3`` / ``grad_accum_steps=3``: a global batch
    of 6, three rows a rank, cut in three, frozen statistics: the middle
    cut splits both ranks (one row each, its loss's global reductions over
    the two, each rank's loss of it divided by 3, of the others by 3/2),
    held by ``assert_near_one_process`` (the module's docstring); the
    gradient average over the ranks is one process's mean over the cuts
    (JAX's chunk mean, which ``tests/test_torch_train_step.py`` holds the
    one-process step to).  Live statistics over split cuts:
    ``test_split_cuts_match_one_process_in_float64``."""
    if "=" in case:
        what = case.split("=")[0]
        cfg = dict(SMALL, freeze_bn_stats=True, **{what: 3})
        batch = _batch(cfg, size=6)
        rank_group.start(train_steps, cfg, 1, batch)
        try:
            want = train_steps(cfg, 1, batch)
        finally:
            ranks = rank_group.wait()
        assert ranks[0]["digest"] == ranks[1]["digest"]
        assert ranks[0]["step"] == ranks[1]["step"] == 1
        assert_near_one_process(ranks[0], want, GRAD_RTOL["handnet"])
        return
    cfg = dict(SMALL)
    if case == "quirks":
        cfg.update(replicate_reference_quirks=True, freeze_bn_stats=True)
    elif case in ("bn_stat_groups", "grad_accum_steps"):
        cfg[case] = 2
    else:
        cfg.update(arch="csp_18")
    batch = _batch(cfg)
    if case == "quirks":
        batch["hm"][1] = 0.0
        batch["valid"][1, 1] = 0.0
    rank_group.start(train_steps, cfg, 1, batch)
    try:
        want = train_steps(cfg, 1, batch)
    finally:
        ranks = rank_group.wait()
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["step"] == ranks[1]["step"] == 1
    _assert_matches(ranks[0], want,
                    GRAD_RTOL["handnet" if case == "quirks" else case])


def assert_f64_cuts_match(ranks, want, peers=1):
    """``conv_act_bn_cuts`` on the ranks against one process: the data
    ranks' output rows (one rank of each ``peers`` model peers; the peers
    equal) together the one process's, and every rank's stats, gradients
    and running statistics (which moved) the one process's, within
    ``F64_RTOL`` (the loss ``F64_LOSS_RTOL``)."""
    for r in ranks:
        assert r["stats"].keys() == want["stats"].keys()
        gap = abs(r["stats"]["loss"] - want["stats"]["loss"])
        assert gap <= F64_LOSS_RTOL * abs(want["stats"]["loss"]), gap
        for n, g in want["grads"].items():
            assert _leaf_gap(r["grads"][n], g) <= F64_RTOL, n
        for n, b in want["buffers"].items():
            assert np.abs(r["buffers"][n] - b).max() <= (
                F64_RTOL * np.abs(b).max()), n
    for i in range(0, len(ranks), peers):
        for r in ranks[i + 1:i + peers]:
            np.testing.assert_array_equal(r["y"], ranks[i]["y"])
    y = np.concatenate([r["y"] for r in ranks[::peers]])
    assert np.abs(y - want["y"]).max() <= F64_RTOL * np.abs(want["y"]).max()


@pytest.mark.parametrize("what", ["bn_stat_groups", "grad_accum_steps"])
def test_split_cuts_match_one_process_in_float64(what, rank_group):
    """Live BatchNorm over cuts that split a rank, in float64, where no
    summation order amplifies: a ``ConvActBN`` trained as the train step
    runs its cuts (``_rank_cuts``, ``_run_cuts``; ``conv_act_bn_cuts``)
    over three cuts of a batch of 6 on the two ranks, the middle one split
    1 + 1 (its BatchNorm sums and their gradient over the two ranks; the
    groups starting from the same statistics and keeping group 0's, the
    chunks' statistics chained over cuts held by one rank and by two),
    against one process running the three cuts in turn: the outputs, the
    gradients and the running statistics within ``F64_RTOL``."""
    x = np.random.RandomState(2).randn(6, 12, 12, 16)
    weights = conv_act_bn_weights(32, 3)
    ranks = rank_group.run(conv_act_bn_cuts, weights, x, what, 3)
    want = conv_act_bn_cuts(weights, x, what, 3)
    for n, b in want["buffers"].items():
        assert np.abs(b - weights["bn." + n]).max() > 1e-2, n
    assert_f64_cuts_match(ranks, want)


@pytest.mark.parametrize("B,world,rank,cuts,want", [
    (8, 2, 1, 4, [(2, slice(0, 2), None), (3, slice(2, 4), None)]),
    (4, 4, 3, 2, [(1, slice(0, 1), [2, 3])]),     # a cut spans two ranks
    (4, 4, 0, 4, [(0, slice(0, 1), None)]),       # one cut a rank
    (4, 4, 2, 1, [(0, slice(0, 1), "data")]),     # the global batch
    (6, 2, 0, 3, [(0, slice(0, 2), None), (1, slice(2, 3), [0, 1])]),
    (6, 2, 1, 3, [(1, slice(0, 1), [0, 1]), (2, slice(1, 3), None)]),
    (12, 3, 0, 2, [(0, slice(0, 4), [0, 1])]),    # uneven: 4 + 2 rows
    (12, 3, 1, 2, [(0, slice(0, 2), [0, 1]), (1, slice(2, 4), [1, 2])]),
    (12, 3, 2, 2, [(1, slice(0, 4), [1, 2])])])   # 2 + 4 rows
def test_batch_cuts_map_onto_ranks(B, world, rank, cuts, want, monkeypatch):
    """How a rank takes its part of ``cuts`` BatchNorm groups or
    accumulation chunks of a global batch of ``B`` (``_rank_cuts``): the
    cuts it runs in order, its rows of each, the ranks a cut's BatchNorm
    sums and loss reduce over (a group of exactly those ranks, every rank
    creating every such group in one order, with each member's rows) or
    none, and the divisor of its loss (its rows of the whole stripe over
    its rows of the cut); no collective runs."""
    import functools

    import torch.distributed as dist

    from pdfnet_tpu_torch.train import step as step_lib
    made = []
    monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(ranks)
                        or tuple(ranks))
    layout = mesh.Layout(world, 1, rank, 0, "data-group")
    plan = step_lib._rank_cuts(B, cuts, "bn_stat_groups", layout)
    R, S = B // world, B // cuts
    spans = [list(range(c * S // R, ((c + 1) * S - 1) // R + 1))
             for c in range(cuts)]
    assert made == [r for r in spans if len(r) > 1] if cuts > 1 else made == []
    assert [(c.index, c.rows) for c in plan] == [w[:2] for w in want]
    for cut, (c, rows, ranks) in zip(plan, want):
        n = rows.stop - rows.start
        assert cut.scale == R / n and cut.ranks == len(spans[c])
        if ranks is None:
            assert cut.ctx is contextlib.nullcontext
            continue
        assert isinstance(cut.ctx, functools.partial)
        assert cut.ctx.func is mesh.global_batch
        group, counts = cut.ctx.args
        assert group == ("data-group" if ranks == "data" else tuple(ranks))
        lo, hi = c * S, (c + 1) * S
        assert counts == [min(hi, (h + 1) * R) - max(lo, h * R)
                          for h in spans[c]]
        assert counts[spans[c].index(rank)] == n


def test_cut_scales_give_the_mean_over_cuts(monkeypatch):
    """Over every rank of each layout, the loss divisors weigh each cut as
    one process's mean over the cuts does: a rank's rows of cut c over its
    divisor, summed over the ranks, are ``world / cuts`` (the average over
    the ranks then takes ``1 / world``: the mean's ``1 / cuts``)."""
    import torch.distributed as dist

    from pdfnet_tpu_torch.train import step as step_lib
    monkeypatch.setattr(dist, "new_group", lambda ranks: None)
    for B, world, cuts in ((8, 2, 4), (4, 4, 2), (6, 2, 3), (12, 3, 2),
                           (6, 3, 2), (12, 4, 3)):
        weight = [0.0] * cuts
        for rank in range(world):
            layout = mesh.Layout(world, 1, rank, 0)
            for cut in step_lib._rank_cuts(B, cuts, "grad_accum_steps",
                                           layout):
                weight[cut.index] += 1.0 / cut.scale
        assert weight == pytest.approx([world / cuts] * cuts), (B, world)


def _jax_zero1_moment_shapes(cfg_kw, model, world):
    """Each port parameter's Adam moment shape on one rank under the JAX
    package's own placement (``zero1_state_shardings`` on the JAX model's
    Adam state, a mesh of ``world``), carried into the port's layout by
    ``convert``: a flax leaf split on its leading axis maps to the port's
    dim along which that axis runs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec

    from pdfnet_tpu.config import Config as JaxConfig
    from pdfnet_tpu.models import build_model as jax_build_model
    from pdfnet_tpu.parallel.mesh import zero1_state_shardings
    from pdfnet_tpu.train.step import TrainState, make_optimizer

    from pdfnet_tpu_torch import convert

    cfg = JaxConfig(**cfg_kw)
    b = _batch(cfg_kw)
    jmodel = jax_build_model(cfg.replace(knn_method="topk",
                                         gather_method="take"))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b["input"][:1], b["choose"][:1],
        b["cloud"][:1], b["depth"][:1], None, b["K_new"][:1],
        b["valid"][:1], train=False))
    opt = jax.eval_shape(make_optimizer(cfg).init, shapes["params"])
    state = TrainState(params=shapes["params"],
                       batch_stats=shapes["batch_stats"], opt_state=opt,
                       step=jax.ShapeDtypeStruct((), jnp.int32))
    placed = zero1_state_shardings(state, AbstractMesh((world,), ("data",)))
    # adam's mu has the params' tree; its placement is the moments'
    mu_spec = placed.opt_state.inner_state[0].mu
    # each flax element's index along its leading axis, plus SPLIT where
    # the leaf's moments are split, carried into the port's layout
    SPLIT = 2.0 ** 20
    coded = jax.tree.map(lambda sh, s: np.broadcast_to(
        np.arange(s.shape[0], dtype=np.float32).reshape(
            (-1,) + (1,) * (len(s.shape) - 1))
        + SPLIT * (sh.spec == PartitionSpec("data")), s.shape),
        mu_spec, shapes["params"])
    lead = convert.params_from_flax(coded, model)
    out = []
    for n, p in model.named_parameters():
        shape, a = list(p.shape), lead[n].numpy()
        if a.flat[0] >= SPLIT:
            (d,) = [ax for ax in range(a.ndim) if np.ptp(a, axis=ax).any()]
            shape[d] //= world
        out.append(tuple(shape))
    return out


def test_zero1_matches_the_replicated_optimizer(rank_group):
    """Two steps with the Adam moments split over the two ranks against
    the same two steps with them replicated (``tests/test_zero1.py:39``
    for JAX): the same parameters, statistics and losses; each rank holds
    the moment shapes the JAX placement gives it."""
    cfg = dict(SMALL, freeze_bn_stats=True)
    batch = _batch(cfg)
    model = port.HandNet(port.Config(**cfg))
    full = [tuple(p.shape) for p in model.parameters()]
    rank_group.start(train_steps, cfg, 1, batch, 2)
    try:
        want = _jax_zero1_moment_shapes(cfg, model, 2)
    finally:
        rep = rank_group.wait()
    z1 = rank_group.run(train_steps, dict(cfg, zero1_opt_sharding=True), 1,
                        batch, 2)
    assert z1[0]["digest"] == z1[1]["digest"] == rep[0]["digest"]
    assert z1[0]["stats"] == rep[0]["stats"]
    for n, p in rep[0]["params"].items():
        np.testing.assert_array_equal(z1[0]["params"][n], p, err_msg=n)
    # the parameters the loss reaches hold moments (torch's Adam skips the
    # others, as the one-process step does)
    held = sorted(rep[0]["moments"])
    assert len(held) > len(full) / 2
    assert sum(want[i] != full[i] for i in held) > 50
    for r in (0, 1):
        assert sorted(z1[r]["moments"]) == sorted(rep[r]["moments"]) == held
        assert [z1[r]["moments"][i] for i in held] == [want[i] for i in held]
        assert [rep[r]["moments"][i] for i in held] == [full[i] for i in held]


def test_hard_example_mining_takes_the_global_top(rank_group):
    """The mean over the hardest 70 % of the global batch of 6 (4 samples)
    and its gradient, from two stripes of 3: a per-rank top would take 2
    of each stripe."""
    losses = np.array([5.0, 4.0, 3.0, 0.5, 0.2, 6.0], np.float32)
    ranks = rank_group.run(hard_example_mining_grad, losses)
    x = torch.from_numpy(losses).requires_grad_(True)
    from pdfnet_tpu_torch.train.priors import hard_example_mining
    v = hard_example_mining(x, 0.7)
    v.backward()
    assert ranks[0][0] == ranks[1][0] == pytest.approx(float(v), rel=1e-7)
    np.testing.assert_allclose(np.concatenate([r[1] for r in ranks]),
                               x.grad.numpy(), rtol=1e-7)
    assert float(v) == pytest.approx((6 + 5 + 4 + 3) / 4)


# ---- mesh.py's functions ------------------------------------------------------

@pytest.mark.parametrize("world,global_batch", [(1, 8), (2, 8), (4, 8),
                                                (3, 8)])
def test_process_local_batch_size_is_jax(world, global_batch, monkeypatch):
    """Against the JAX function at the same process count, its error
    text included."""
    import jax
    from pdfnet_tpu.parallel import mesh as jax_mesh
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    if global_batch % world:
        with pytest.raises(ValueError) as want:
            jax_mesh.process_local_batch_size(global_batch)
        with pytest.raises(ValueError) as got:
            mesh.process_local_batch_size(global_batch)
        assert str(got.value) == str(want.value)
    else:
        assert (mesh.process_local_batch_size(global_batch)
                == jax_mesh.process_local_batch_size(global_batch))


def test_one_process_has_no_group(monkeypatch):
    """Without flags or torch's environment variables nothing is set up,
    and every function answers for one process."""
    for k in mesh.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed() is False
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.batch_stripe(3) == (0, 3)
    x = torch.arange(3.0)
    assert mesh.batch_sum(x) is x and mesh.batch_gather(x) is x


def test_the_card_needs_nccl(monkeypatch):
    """A process group on the card is NCCL's; without NCCL it raises
    instead of falling back to gloo."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        mesh.maybe_initialize_distributed("127.0.0.1:1", 1, 0, device="cuda")


def test_metric_accumulators_merge_over_ranks(rank_group):
    """Two ranks' accumulators over disjoint stripes of a fake eval stream,
    merged, against one accumulator over all of it: the same sums, count,
    score block and submission rows."""
    from pdfnet_tpu_torch.train.metrics import MetricAccumulator
    from test_metrics_parity import _fake_eval_stream
    feed = _fake_eval_stream(n=7)
    ranks = rank_group.run(merged_metrics, feed)
    one = MetricAccumulator()
    for out, batch in feed:
        one.update(out, batch)
    for r in ranks:
        assert r["count"] == one.count == 7
        for k, v in one.result().items():
            assert r["result"][k] == pytest.approx(v, rel=1e-12)
        assert r["block"] == one.format_block("x")
        assert r["rows"] == one._action_lists


# ---- fit and checkpoints ------------------------------------------------------

FIT_CFG = dict(SMALL, freeze_bn_stats=True, zero1_opt_sharding=True,
               num_epochs=2, eval_batch_size=2, lr=1e-7)


def _load(path):
    # memory-mapped: a checkpoint of the small HandNet and its Adam state
    # is ~1 GB
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, emptied after the test (its checkpoints take ~1 GB
    each)."""
    import shutil
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# Of each first moment's norm.  On the synthetic hands of ``fit_run`` one
# process's float32 gradient at batch 2 lies up to 2.7e-2 of a leaf's norm
# from the mean of its two batch-1 gradients (a mesh decoder norm; in
# float64 the two agree within 4e-13, so it is rounding, not coupling), and
# up to 0.64 for the leaves whose gradients cancel (``CANCELLING``): the
# attention key biases (softmax) and the level-0 SFT, which scales and
# shifts the raw clouds before the translation-invariant grouping.
MOMENT_RTOL = 5e-2
CANCELLING = ("wk.bias", "pointnet.sft0.")


def _assert_checkpoints_match(got, want, lr):
    """Two runs' checkpoints after each of the same steps (lists in step
    order): the structure, the statistics, every first Adam moment within
    ``MOMENT_RTOL`` (but ``CANCELLING``), and the last parameters within
    the step's bound (``_assert_matches``) wherever every step's gradient
    (recovered from consecutive moments, optax's b1 = 0.9) stands above
    1e-3 of the leaf's largest entry and agrees within 1e-4 (an Adam move
    is as far off as its gradient ratios)."""
    grads = {}
    for t, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == t + 1
        assert g["epoch"] == w["epoch"]
        assert sorted(g["params"]) == sorted(w["params"])
        for n, b in w["batch_stats"].items():
            np.testing.assert_allclose(g["batch_stats"][n], b, err_msg=n,
                                       **BN_TOL)
        assert g["opt_state"]["param_groups"] == w["opt_state"]["param_groups"]
        names = list(w["params"])
        sw, sg = w["opt_state"]["state"], g["opt_state"]["state"]
        assert sorted(sw) == sorted(sg)
        for i, s in sw.items():
            m_w, m_g = s["exp_avg"].numpy(), sg[i]["exp_avg"].numpy()
            assert m_w.shape == m_g.shape
            assert s["exp_avg_sq"].shape == sg[i]["exp_avg_sq"].shape
            if any(c in names[i] for c in CANCELLING):
                continue
            err = np.linalg.norm(m_g - m_w) / max(np.linalg.norm(m_w), 1e-30)
            assert err <= MOMENT_RTOL, f"moment of {names[i]}: {err:.3e}"
            prev = grads.get(i, [(0.0, 0.0, 0.0, 0.0)])[-1]
            grads.setdefault(i, []).append(
                (m_w, m_g, (m_w - 0.9 * prev[0]) / 0.1,
                 (m_g - 0.9 * prev[1]) / 0.1))
    n_held = n_all = 0
    last_g, last_w = got[-1], want[-1]
    names = list(last_w["params"])
    for i, steps in grads.items():
        held = True
        for _, _, g_w, g_g in steps:
            held = held & (np.abs(g_w) > ADAM_GRAD_FLOOR * np.abs(g_w).max()
                           ) & (np.abs(g_g - g_w) < 1e-4 * np.abs(g_w))
        p_w = last_w["params"][names[i]].numpy()
        d = (last_g["params"][names[i]].numpy() - p_w)[held]
        assert (np.abs(d) <= len(steps) * ADAM_RTOL * lr
                + 2 * np.spacing(np.abs(p_w))[held]).all(), names[i]
        n_held += int(np.sum(held))
        n_all += p_w.size
    # the check holds 4.3-7 % of the 86.8 M entries in these tests' runs
    assert n_held > n_all / 50, (n_held, n_all)


def _losses(log_dir):
    import glob
    import json
    (path,) = glob.glob(os.path.join(str(log_dir), "**", "log.jsonl"),
                        recursive=True)
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fit_over_two_ranks_writes_the_one_process_checkpoint(rank_group,
                                                              scratch):
    """``fit`` for 2 steps (2 epochs of 1) on two ranks with ZeRO-1, an
    evaluation and a checkpoint each epoch, against one process with the
    same kNN selections (``shared_selections``): the checkpoints within the
    step's bounds (lr 1e-7: at 1e-4 Adam's first step turns float32 sign
    noise in gradients near zero into 2 lr moves that the second step's
    gradient then feels, see tests/test_torch_trainer.py), the logged
    losses, the score blocks; rank 0 alone writes files."""
    one = fit_run(FIT_CFG, str(scratch / "one"), 1)
    assert one["zero1"] == "Adam" and len(one["selections"]) == 4
    ranks = rank_group.run(fit_run, FIT_CFG, str(scratch / "two"), 1,
                           one["selections"])
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["zero1"] == "Zero1Adam"
    assert not (scratch / "two" / "rank1").exists()
    two_dir, one_dir = scratch / "two" / "rank0", scratch / "one" / "rank0"
    ckpts = lambda d: [_load(d / "ckpt" / f"model_{e}") for e in (0, 1)]
    _assert_checkpoints_match(ckpts(two_dir), ckpts(one_dir), 1e-7)
    for a, b in zip(_losses(two_dir), _losses(one_dir)):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
    # the score blocks of the merged striped evaluations (each epoch), at
    # batch 2 on each rank's records against batch 2 on all of them
    read = lambda d: [float(line.split(": ")[1]) for line in (
        d / "logs" / "H2O-val.txt").read_text().splitlines() if ": " in line]
    assert len(read(one_dir)) == 16
    np.testing.assert_allclose(read(two_dir), read(one_dir), rtol=1e-4)


def test_checkpoints_cross_between_one_and_two_ranks(rank_group, scratch):
    """A checkpoint written by one process loads in two ranks with ZeRO-1
    (each rank keeps its slice of the moments), and what the two ranks save
    again is the same file, bit for bit; and it loads back in one
    process."""
    from pdfnet_tpu_torch.train.trainer import Trainer
    cfg = dict(SMALL, freeze_bn_stats=True)
    one = Trainer(port.Config(**cfg), device="cpu")
    one.init_state()
    one.train_step(one.state, _batch(cfg), 0, LR)
    src = one.save(str(scratch / "one"), 3)
    out = rank_group.run(checkpoint_round_trip,
                         dict(cfg, zero1_opt_sharding=True), src,
                         str(scratch / "two"))
    assert out[1] is None and out[0] == str(scratch / "two" / "model_3")
    a, b = _load(src), _load(out[0])
    assert a.keys() == b.keys() and a["step"] == b["step"] == 1
    for part in ("params", "batch_stats"):
        for n, v in a[part].items():
            assert torch.equal(b[part][n], v), n
    assert a["opt_state"]["param_groups"] == b["opt_state"]["param_groups"]
    for i, s in a["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(b["opt_state"]["state"][i][k], v), (i, k)
    again = Trainer(port.Config(**cfg), device="cpu")
    again.init_state()
    assert again.load(out[0]) == 3 and again.state.step == 1
    for (n, p), q in zip(one.model.named_parameters(),
                         again.model.parameters()):
        assert torch.equal(p, q), n


# ---- the CLI ------------------------------------------------------------------

class _Reached(Exception):
    pass


@pytest.mark.parametrize("argv,env,want", [
    (["--coordinator", "localhost:1234", "--num_processes", "2",
      "--process_id", "1"], {},
     dict(backend="gloo", init_method="tcp://localhost:1234", world_size=2,
          rank=1)),
    (["--coordinator", "127.0.0.1:9", "--num_processes", "1",
      "--process_id", "0"], {},
     dict(backend="gloo", init_method="tcp://127.0.0.1:9", world_size=1,
          rank=0)),
    ([], {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500",
          "WORLD_SIZE": "2", "RANK": "0"},
     dict(backend="gloo", init_method="env://"))])
def test_cli_flags_reach_init_process_group(argv, env, want, monkeypatch,
                                            tmp_path):
    """The multi-process flags, or torch's environment rendezvous, reach
    ``init_process_group`` (gloo under ``--cpu``) before any data is
    read."""
    import torch.distributed as dist

    from pdfnet_tpu_torch.cli.main import main
    seen = {}

    def fake(backend, **kw):
        seen.update(backend=backend, **kw)
        raise _Reached

    monkeypatch.setattr(dist, "init_process_group", fake)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(_Reached):
        main(argv + ["--cpu", "--cache_path", str(tmp_path / "none")])
    assert seen == want


def _cli_args(out):
    return ["--cpu", "--synthetic", "--mode", "train", "--output_path",
            str(out), "--default_resolution", "64", "--sample_num", "256",
            "--sample_num_level1", "128", "--sample_num_level2", "128",
            "--knn_k", "8", "--compute_dtype", "float32", "--batch_size",
            "2", "--num_epochs", "2", "--steps", "1", "--eval_every", "0",
            "--save_every", "1", "--freeze_bn_stats", "--lr", "1e-7"]


def test_cli_trains_two_processes_to_the_one_process_checkpoint(scratch):
    """``python -m pdfnet_tpu_torch.cli.main --cpu --synthetic --mode
    train`` in two processes joined by ``--coordinator --num_processes 2
    --process_id i`` writes the checkpoints one process writes for the same
    global batches (2 steps, 2 epochs of 1; within the bounds of
    ``_assert_checkpoints_match``, the train steps sharing the one
    process's kNN selections, ``run_cli``; dropout on, drawn for the global
    batch on every rank); the second process writes nothing."""
    import subprocess
    import sys

    from test_torch_ranks import free_port, run_cli
    tests = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(tests)
    sels = str(scratch / "selections.pkl")
    run_cli(_cli_args(scratch / "one"), sels, True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [tests, repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from test_torch_ranks import "
         "run_cli; run_cli(sys.argv[2:], sys.argv[1], False)", sels,
         *_cli_args(scratch / f"out{i}"), "--coordinator", coord,
         "--num_processes", "2", "--process_id", str(i)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "multi-host: process 0 of 2" in logs[0]
    assert not (scratch / "out1").exists()
    ckpts = lambda d: [_load(d / "ckpt" / "default" / f"model_{e}")
                       for e in (0, 1)]
    _assert_checkpoints_match(ckpts(scratch / "out0"),
                              ckpts(scratch / "one"), 1e-7)
    for a, b in zip(_losses(scratch / "out0"), _losses(scratch / "one")):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
