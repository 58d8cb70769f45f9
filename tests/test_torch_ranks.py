"""Gloo ranks on the CPU for the port's multi-process tests, and the
programs they run.

``RankGroup(world)`` spawns ``world`` processes once (each imports torch
and the port only and keeps one torch thread), joins them in a gloo group
on a free local port, and runs each ``run(program, *args)`` on every rank:
``program(*args)`` is a module-level function of a module that imports no
JAX (this one), and ``run`` returns the ranks' results in rank order.
Every run has its own timeout: a hang or a crash kills the group, fails
that test alone, and the next run starts a new group.  ``rank_group`` is
the module's fixture (one group of two ranks a module and test worker).

The programs take the whole global batch and give each rank its stripe
(``stripe``: rank 0's rows first, as the JAX package assembles a global
batch from process-local data, ``make_array_from_process_local_data``).
Called without a process group they are the one-process reference.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib
import multiprocessing
import os
import socket
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

RUN_TIMEOUT = 300.0          # seconds a program may take on every rank
SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8,
             batch_size=2, dropout=0.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, jobs, results):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=RUN_TIMEOUT))
    while True:
        job = jobs.get()
        if job is None:
            break
        module, name, args = job
        try:
            out = ("ok", getattr(importlib.import_module(module), name)(*args))
        except BaseException:                          # noqa: BLE001
            out = ("error", traceback.format_exc())
        results.put((rank, out))
        del out
        gc.collect()
    dist.destroy_process_group()


class RankGroup:
    def __init__(self, world: int = 2):
        self.world = world
        self.procs = []

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self.jobs = [ctx.Queue() for _ in range(self.world)]
        self.results = ctx.Queue()
        env = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            self.procs = [ctx.Process(target=_serve, daemon=True,
                                      args=(r, self.world, port,
                                            self.jobs[r], self.results))
                          for r in range(self.world)]
            for p in self.procs:
                p.start()
        finally:
            if env is None:
                os.environ.pop("OMP_NUM_THREADS")
            else:
                os.environ["OMP_NUM_THREADS"] = env

    def run(self, program, *args, timeout: float = RUN_TIMEOUT):
        """``program(*args)`` on every rank; the results in rank order."""
        self.start(program, *args)
        return self.wait(timeout)

    def start(self, program, *args):
        """Start ``program(*args)`` on every rank; ``wait`` returns the
        results (the caller works meanwhile, and must wait)."""
        if not self.procs or not all(p.is_alive() for p in self.procs):
            self.close()
            self._start()
        for q in self.jobs:
            q.put((program.__module__, program.__name__, args))

    def wait(self, timeout: float = RUN_TIMEOUT):
        out = [None] * self.world
        try:
            for _ in range(self.world):
                rank, (status, value) = self.results.get(timeout=timeout)
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        except BaseException:
            self.close()
            raise
        return out

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        self.procs = []


@pytest.fixture(scope="module")
def rank_group():
    """Two ranks for the module's tests, stopped after them (each holds a
    model and its optimizer while alive)."""
    group = RankGroup(2)
    yield group
    group.close()


# ---- what the ranks run -----------------------------------------------------

def stripe(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of every per-sample entry of a global batch."""
    B = batch["input"].shape[0]
    b = B // world
    return {k: v[rank * b:(rank + 1) * b]
            if getattr(v, "ndim", 0) and v.shape[0] == B else v
            for k, v in batch.items()}


def _where():
    """(this rank's data index, the data ranks): its rank and the world
    size, or its place on the data axis of a 2-D layout."""
    from pdfnet_tpu_torch.parallel import mesh
    layout = mesh.current_mesh()
    return layout.data_index, layout.data


def seeded_state(model: torch.nn.Module, seed: int = 1) -> dict:
    """Seeded random weights from one torch generator (the same bits in
    every process): lecun-normal kernels, every bias, norm gain and running
    statistic uniform as ``tests/test_torch_train_step.py`` draws them, the
    modules' own initial values elsewhere, hand-sized vertex offsets."""
    from pdfnet_tpu_torch.models.layers import BatchNorm
    gen = torch.Generator().manual_seed(seed)
    norms = {n for n, m in model.named_modules()
             if isinstance(m, (BatchNorm, torch.nn.LayerNorm))}
    state = model.state_dict()
    with torch.no_grad():
        for name, t in state.items():
            if not t.is_floating_point():
                continue
            owner, leaf = name.rsplit(".", 1)
            if leaf == "running_var":
                t.uniform_(0.5, 2.0, generator=gen)
            elif leaf in ("bias", "running_mean"):
                t.uniform_(-0.3, 0.3, generator=gen)
            elif leaf == "weight" and owner in norms:
                t.uniform_(0.7, 1.3, generator=gen)
            elif t.dim() >= 2:
                t.normal_(0.0, t[0].numel() ** -0.5, generator=gen)
            if owner == "decoder.coord_head":
                t.mul_(0.01)
    return state


def load_weights(model: torch.nn.Module, weights) -> None:
    """``weights``: a seed for ``seeded_state``, a state dict, or (a seed,
    a dict of entries that replace its values)."""
    if isinstance(weights, int):
        weights = seeded_state(model, weights)
    elif isinstance(weights, tuple):
        seed, over = weights
        weights = dict(seeded_state(model, seed), **over)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in weights.items()})


def split_model(model: torch.nn.Module, mesh_2d) -> dict:
    """``make_mesh_2d(*mesh_2d)`` and ``shard_params_tp`` of ``model`` on
    it: the plan; {} without a 2-D mesh."""
    from pdfnet_tpu_torch.parallel import mesh
    if mesh_2d is None:
        return {}
    return mesh.shard_params_tp(model, mesh.make_mesh_2d(*mesh_2d))


def build(cfg_kw: dict, weights=1, mesh_2d=None):
    """(cfg, model in train mode, train step, state, the split plan) at
    ``cfg_kw`` with ``weights`` (``load_weights``), split over a (data,
    model) layout ``mesh_2d`` when given ({} otherwise); the state is
    ``create_train_state``'s, in a process group its data-parallel
    one."""
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.models.csp import csp_from_config
    from pdfnet_tpu_torch.train.mano_branch import load_mano_branch_consts
    from pdfnet_tpu_torch.train.step import make_csp_train_step
    cfg = port.Config(**cfg_kw)
    csp = cfg.arch.startswith("csp")
    model = csp_from_config(cfg) if csp else port.HandNet(cfg)
    load_weights(model, weights)
    model.train()
    plan = split_model(model, mesh_2d)
    state = port.create_train_state(cfg, model)
    step = (make_csp_train_step(cfg, model, load_mano_branch_consts("cpu"))
            if csp else
            port.make_train_step(cfg, model, port.load_loss_consts("cpu")))
    return cfg, model, step, state, plan


def _digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def _digest_tree(tree: dict) -> str:
    h = hashlib.sha256()
    for part in ("params", "batch_stats"):
        for v in tree[part].values():
            h.update(v.numpy().tobytes())
    return h.hexdigest()


def _replaying(selections, B):
    """``knn_plain`` that returns the recorded selections of a global
    batch of ``B`` (this rank's rows of each), as ``run_port`` in
    ``tests/test_torch_train_step.py`` replays the JAX step's: the two
    sides' clouds differ in the last bit (other summation orders), and a
    neighbour on a tie or on the ball's radius then flips on one side,
    moving its gradient to another point."""
    replay = list(selections)

    def knn_plain(xyz, num_centers, k):
        rank, world = _where()
        ref, ref_idx = replay.pop(0)
        per = ref_idx.shape[0] // B
        rows = slice(rank * per * B // world, (rank + 1) * per * B // world)
        ref, ref_idx = ref[rows], ref_idx[rows]
        if ref.dtype == np.bool_:   # group_feat_pallas returns validity
            ref = np.where(ref, np.float32(0), np.float32(np.inf))
        return (torch.from_numpy(np.array(ref)),
                torch.from_numpy(ref_idx.astype(np.int64)))
    return knn_plain, replay


@contextlib.contextmanager
def _knn(fn):
    from pdfnet_tpu_torch.ops import grouping, sa
    saved = (grouping.knn_plain, sa.knn_plain)
    grouping.knn_plain = sa.knn_plain = fn
    try:
        yield
    finally:
        grouping.knn_plain, sa.knn_plain = saved


@contextlib.contextmanager
def shared_selections(selections: list, B: int):
    """Around every train step the trainer makes: an empty
    ``selections`` records each kNN selection of the global batch of
    ``B``; a full one is replayed (this rank's rows).  The evaluation
    keeps its own selections."""
    from pdfnet_tpu_torch.ops.sa import knn_plain as plain
    from pdfnet_tpu_torch.train import trainer as trainer_lib
    left = []
    if selections:
        knn, left = _replaying(selections, B)
    else:
        def knn(xyz, num_centers, k):
            d, i = plain(xyz, num_centers, k)
            selections.append((d.numpy().copy(), i.numpy().copy()))
            return d, i
    make = trainer_lib.make_train_step

    def make_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*a, **k):
            with _knn(knn):
                return step(*a, **k)
        return run

    trainer_lib.make_train_step = make_step
    try:
        yield
    finally:
        trainer_lib.make_train_step = make
    assert not left, "selections left over"


def train_steps(cfg_kw: dict, weights, batch: dict, steps: int = 1,
                epoch: int = 30, lr: float = 1e-4, selections=None,
                mesh_2d=None, seed=None) -> dict:
    """``steps`` train steps of the global ``batch`` (this rank's stripe of
    it, by data index), the model split over a (data, model) layout
    ``mesh_2d`` when given, dropout drawn from a generator seeded ``seed +
    step`` when ``seed`` is given: every step's stats, the first step's
    gradients, then the parameters and running statistics (rank 0's; the
    other ranks return a digest of their parameters, of the gathered ones
    and the statistics under a 2-D layout), the step count, the shape of
    every Adam moment this rank holds and, under a 2-D layout, the plan
    and the shape of every stored parameter.  Gradients and parameters
    of split leaves are gathered over the model group (unsplit names)."""
    from pdfnet_tpu_torch.ops.sa import knn_plain
    from pdfnet_tpu_torch.parallel import mesh
    cfg, model, step, state, plan = build(cfg_kw, weights, mesh_2d)
    rank, world = _where()
    local = stripe(batch, rank, world)
    knn, left = ((knn_plain, []) if selections is None else
                 _replaying(selections, batch["input"].shape[0]))
    stats, grads = [], None
    with _knn(knn):
        for i in range(steps):
            gen = (None if seed is None
                   else torch.Generator().manual_seed(seed + i))
            s = step(state, local, epoch, lr, gen)
            stats.append({k: float(v) for k, v in s.items()})
            if grads is None:
                grads = {mesh.plain_name(n): mesh.unshard(
                    model, n, p.grad if p.grad is not None
                    else torch.zeros_like(p)).numpy()
                    for n, p in model.named_parameters()}
    assert not left, "selections left over"
    opt = state.optimizer
    leaves = [p for g in opt.param_groups for p in g["params"]]
    out = {"stats": stats, "digest": _digest(model), "step": state.step,
           "moments": {i: tuple(opt.state[p]["exp_avg"].shape)
                       for i, p in enumerate(leaves) if p in opt.state}}
    if mesh_2d is None:
        params = {n: p.detach() for n, p in model.named_parameters()}
    else:
        host = mesh.gather_to_host(state)
        params = host["params"]
        out["digest"] = _digest_tree(host)
        out["plan"] = plan
        out["stored"] = {mesh.plain_name(n): tuple(p.shape)
                         for n, p in model.named_parameters()}
        out["host_moments"] = {i: tuple(s["exp_avg"].shape) for i, s in
                               host["opt_state"]["state"].items()}
    if mesh.process_index() == 0:
        out["grads"] = grads
        out["params"] = {n: p.numpy().copy() for n, p in params.items()}
        out["buffers"] = {n: b.numpy().copy()
                          for n, b in model.named_buffers()
                          if n.endswith(("running_mean", "running_var"))}
    return out


SERVE_INPUTS = ("input", "depth", "K_new", "valid")


def eval_outputs_of(cfg_kw: dict, weights, batch: dict, serve: bool,
                    mesh_2d=None) -> dict:
    """The eval step (``make_eval_step``) or, with ``serve``, the serving
    step (``infer_rgbd`` + ``eval_outputs``) on this rank's stripe of
    ``batch`` (by data index), the model split over ``mesh_2d`` when
    given: every output as numpy."""
    import pdfnet_tpu_torch as port
    cfg = port.Config(**cfg_kw)
    model = port.HandNet(cfg)
    load_weights(model, weights)
    model.eval()
    split_model(model, mesh_2d)
    rank, world = _where()
    local = stripe(batch, rank, world)
    consts = port.load_loss_consts("cpu")
    if serve:
        out = port.infer_rgbd(model, *[local[k] for k in SERVE_INPUTS])
        out = port.eval_outputs(cfg, consts, *out, {
            "K_new": torch.from_numpy(local["K_new"])})
    else:
        out = port.make_eval_step(cfg, model, consts)(local)
    return {k: v.numpy().copy() for k, v in out.items() if torch.is_tensor(v)}


def conv_act_bn_train(weights: dict, x: np.ndarray) -> dict:
    """One train-mode call of ``ConvActBN(16, 32, 3)`` on this rank's
    stripe of the NHWC batch ``x`` inside ``global_batch``: its output
    stripe and running statistics."""
    from pdfnet_tpu_torch.models.layers import ConvActBN
    from pdfnet_tpu_torch.parallel import mesh
    rank, world = _where()
    module = ConvActBN(16, 32, 3)
    module.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    xs = stripe({"input": x}, rank, world)["input"]
    with mesh.global_batch():
        y = module.train()(torch.from_numpy(
            np.ascontiguousarray(xs.transpose(0, 3, 1, 2))))
    return {"y": y.detach().numpy(),
            "buffers": {k: v.numpy() for k, v in module.state_dict().items()
                        if "running" in k}}


def conv_act_bn_weights(cout: int, kernel: int, seed: int = 0) -> dict:
    """Seeded float64 weights of ``ConvActBN(16, cout, kernel)``."""
    rng = np.random.RandomState(seed)
    return {"conv.weight": rng.randn(cout, 16, kernel, kernel)
            * (16 * kernel * kernel) ** -0.5,
            "bn.weight": rng.uniform(0.7, 1.3, cout),
            "bn.bias": rng.uniform(-0.3, 0.3, cout),
            "bn.running_mean": rng.uniform(-0.3, 0.3, cout),
            "bn.running_var": rng.uniform(0.5, 2.0, cout),
            "bn.num_batches_tracked": np.zeros((), np.int64)}


def conv_act_bn_cuts(weights: dict, x: np.ndarray, what: str, cuts: int,
                     mesh_2d=None) -> dict:
    """The forward and backward of one train step (``train/step.py``'s
    ``_rank_cuts`` and ``_run_cuts``) of a float64 ``ConvActBN`` with live
    BatchNorm (``weights``, ``conv_act_bn_weights``) over ``cuts``
    BatchNorm groups or accumulation chunks (``what``) of the NHWC global
    batch ``x``, on this rank's stripe by data index: every rank a data
    rank, or the module split over a (data, model) layout ``mesh_2d``; one
    process without a group.  A cut's loss is the mean over its rows of
    the squared outputs, weighted by channel.  Returns this rank's output
    rows (in row order), the stats, the gradients (whole) and the running
    statistics."""
    from pdfnet_tpu_torch.models.layers import ConvActBN
    from pdfnet_tpu_torch.parallel import mesh
    from pdfnet_tpu_torch.train import step as step_lib
    cout, cin, k, _ = weights["conv.weight"].shape
    module = ConvActBN(cin, cout, k).double()
    module.load_state_dict({n: torch.as_tensor(v) for n, v in weights.items()})
    module.train()
    layout = None
    if mesh_2d is not None:
        layout = mesh.make_mesh_2d(*mesh_2d)
        mesh.shard_params_tp(module, layout)
    elif mesh.is_distributed():
        layout = mesh.Layout(mesh.process_count(), 1, mesh.process_index(),
                             0)
    d, D = (0, 1) if layout is None else (layout.data_index, layout.data)
    xs = stripe({"input": x}, d, D)["input"]
    b = {"input": torch.from_numpy(np.ascontiguousarray(
        xs.transpose(0, 3, 1, 2)))}
    plan = step_lib._rank_cuts(x.shape[0], cuts, what, layout)
    coef = torch.linspace(0.5, 1.5, cout, dtype=torch.float64).view(
        1, -1, 1, 1)
    ys = []

    def loss_of(bc):
        y = module(bc["input"])
        ys.append(y.detach())
        loss = (coef * y * y).mean(dim=(1, 2, 3)).mean()
        return loss, {"loss": loss}

    norms = [module.bn]
    stats = step_lib._run_cuts(module, plan, b, loss_of,
                              what == "bn_stat_groups" and cuts > 1,
                              step_lib._norm_stats(norms), layout)
    return {"y": torch.cat(ys).numpy(),
            "stats": {n: float(v) for n, v in stats.items()},
            "grads": {mesh.plain_name(n): mesh.unshard(module, n,
                                                       p.grad).numpy()
                      for n, p in module.named_parameters()},
            "buffers": {n: v.numpy().copy() for n, v in
                        module.bn.state_dict().items() if "running" in n}}


def hard_example_mining_grad(losses: np.ndarray) -> tuple:
    """``hard_example_mining`` of the global per-sample ``losses`` from
    this rank's stripe: (the value, the gradient of this rank's stripe
    averaged over the ranks as ``all_reduce_grads`` averages)."""
    from pdfnet_tpu_torch.parallel import mesh
    from pdfnet_tpu_torch.train.priors import hard_example_mining
    rank, world = _where()
    x = torch.from_numpy(stripe({"input": losses}, rank, world)["input"])
    x.requires_grad_(True)
    with mesh.global_batch():
        v = hard_example_mining(x, 0.7)
        v.backward()
    return float(v), (x.grad / world).numpy()


def merged_metrics(feed: list) -> dict:
    """A ``MetricAccumulator`` over this rank's share of ``feed`` (every
    world-th (out, batch) pair from the rank's index), merged over the
    ranks: its results, count and submission rows."""
    from pdfnet_tpu_torch.train.metrics import MetricAccumulator
    rank, world = _where()
    acc = MetricAccumulator()
    for out, batch in feed[rank::world]:
        acc.update(out, batch)
    assert acc.all_reduce() is acc
    return {"result": acc.result(), "count": acc.count,
            "rows": acc._action_lists, "block": acc.format_block("x")}


def fit_run(cfg_kw: dict, out_dir: str, steps: int,
            selections=None) -> dict:
    """``fit`` on the synthetic hands for ``steps`` steps of one epoch,
    with an evaluation and a checkpoint, this rank writing under
    ``{out_dir}/rank{rank}`` (only rank 0 may write there); the train
    steps record their kNN selections, or replay ``selections``
    (``shared_selections``).  Returns what the trainer holds afterwards
    and the selections."""
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.data.synthetic import SyntheticHandDataset
    from pdfnet_tpu_torch.train import trainer as trainer_lib
    rank, _ = _where()
    cfg = port.Config(**cfg_kw)
    base = os.path.join(out_dir, f"rank{rank}")
    # the trainer's weights are seeded_state's (hand-sized vertex offsets:
    # at the initializers' scale the decoded joints lie near the camera
    # plane, where the 2-D terms amplify float32 noise)
    saved = trainer_lib.init_weights
    trainer_lib.init_weights = lambda model, seed: seeded_state(model)
    selections = [] if selections is None else selections
    try:
        with shared_selections(selections, cfg.batch_size):
            trainer = trainer_lib.fit(
            cfg, SyntheticHandDataset(cfg, size=4 * cfg.batch_size),
                SyntheticHandDataset(cfg, size=3, seed=1, train=False),
                log_dir=os.path.join(base, "logs"),
                ckpt_dir=os.path.join(base, "ckpt"), eval_every=1,
                save_every=1, max_steps_per_epoch=steps, device="cpu")
    finally:
        trainer_lib.init_weights = saved
    return {"step": trainer.state.step, "digest": _digest(trainer.model),
            "zero1": type(trainer.state.optimizer).__name__,
            "selections": selections}


def run_cli(argv: list, selections_file: str, record: bool) -> None:
    """``python -m pdfnet_tpu_torch.cli.main`` with ``argv``, its train
    steps recording their kNN selections into ``selections_file`` or
    replaying them from it (``shared_selections``)."""
    import pickle
    import runpy
    import sys
    torch.set_num_threads(1)
    sels = []
    if not record:
        with open(selections_file, "rb") as f:
            sels = pickle.load(f)
    batch = int(argv[argv.index("--batch_size") + 1])
    sys.argv = ["pdfnet_tpu_torch.cli.main", *argv]
    with shared_selections(sels, batch):
        runpy.run_module("pdfnet_tpu_torch.cli.main", run_name="__main__",
                         alter_sys=True)
    if record:
        with open(selections_file, "wb") as f:
            pickle.dump(sels, f)


def checkpoint_round_trip(cfg_kw: dict, path: str, out_dir: str) -> str:
    """Load the checkpoint ``path`` (written by any number of ranks) into
    a fresh trainer and save it again under ``out_dir`` (rank 0 writes);
    returns the path rank 0 wrote, None on the other ranks."""
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.train.trainer import Trainer
    trainer = Trainer(port.Config(**cfg_kw), device="cpu")
    trainer.init_state()
    epoch = trainer.load(path)
    return trainer.save(out_dir, epoch)


def column_parallel_gaps(mesh_2d, seed: int = 0) -> dict:
    """Each module kind that ``shard_params_tp`` splits (Linear, Conv2d on
    NCHW and on ``channels_last`` input, ConvTranspose2d, StridedUpConv,
    Embedding read whole), in float64 at a width of 256 split over
    ``make_mesh_2d(*mesh_2d)``'s model axis, against an unsplit copy: the
    largest difference of the output, the input's gradient and every
    parameter's (gathered) gradient, by kind, for ``(y * r).sum()`` with a
    fixed ``r``."""
    import copy

    from torch import nn

    from pdfnet_tpu_torch.models.layers import StridedUpConv
    from pdfnet_tpu_torch.parallel import mesh
    layout = mesh.make_mesh_2d(*mesh_2d)
    gen = torch.Generator().manual_seed(seed)
    kinds = {"linear": (lambda: nn.Linear(8, 256), (3, 5, 8)),
             "conv": (lambda: nn.Conv2d(4, 256, 3, padding=1), (2, 4, 6, 6)),
             "conv_channels_last": (lambda: nn.Conv2d(4, 256, 1, bias=False),
                                    (2, 4, 6, 6)),
             "conv_transpose": (lambda: nn.ConvTranspose2d(
                 4, 256, 4, stride=2, padding=1), (2, 4, 5, 5)),
             "strided_up_conv": (lambda: StridedUpConv(4, 256, 2),
                                 (2, 4, 3, 3)),
             "embedding": (lambda: nn.Embedding(7, 256), None)}
    out = {}
    for kind, (make, shape) in kinds.items():
        ref = make().double()
        with torch.no_grad():
            for p in ref.parameters():
                p.copy_(torch.randn(p.shape, generator=gen,
                                    dtype=torch.float64))
        holder = nn.Module()
        holder.m = copy.deepcopy(ref)
        plan = mesh.shard_params_tp(holder, layout)
        assert "m.weight" in plan, (kind, plan)
        x = None if shape is None else torch.randn(shape, generator=gen,
                                                   dtype=torch.float64)
        if kind == "conv_channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        runs = []
        for m in (ref, holder.m):
            xi = None if x is None else x.clone().requires_grad_(True)
            y = m.weight * 1.0 if xi is None else m(xi)
            r = torch.sin(torch.arange(y.numel(), dtype=torch.float64))
            (y * r.reshape(y.shape)).sum().backward()
            grads = {mesh.plain_name(n): mesh.unshard(holder, "m." + n,
                                                      p.grad)
                     if m is holder.m else p.grad
                     for n, p in m.named_parameters()}
            runs.append((y.detach(), None if xi is None else xi.grad, grads))
        (y0, gx0, g0), (y1, gx1, g1) = runs
        gaps = [float((y0 - y1).abs().max())]
        if gx0 is not None:
            gaps.append(float((gx0 - gx1).abs().max()))
        gaps += [float((g0[n] - g1[n]).abs().max()) for n in g0]
        out[kind] = max(gaps)
    return out
