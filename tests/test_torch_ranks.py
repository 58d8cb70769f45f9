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
    from pdfnet_tpu_torch.parallel import mesh
    return mesh.process_index(), mesh.process_count()


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


def build(cfg_kw: dict, weights=1):
    """(cfg, model in train mode, train step, state) at ``cfg_kw`` with
    ``weights`` (a seed for ``seeded_state`` or a state dict); the state
    is ``create_train_state``'s, in a process group its data-parallel
    one."""
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.models.csp import csp_from_config
    from pdfnet_tpu_torch.train.mano_branch import load_mano_branch_consts
    from pdfnet_tpu_torch.train.step import make_csp_train_step
    cfg = port.Config(**cfg_kw)
    csp = cfg.arch.startswith("csp")
    model = csp_from_config(cfg) if csp else port.HandNet(cfg)
    if isinstance(weights, int):
        weights = seeded_state(model, weights)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in weights.items()})
    model.train()
    state = port.create_train_state(cfg, model)
    step = (make_csp_train_step(cfg, model, load_mano_branch_consts("cpu"))
            if csp else
            port.make_train_step(cfg, model, port.load_loss_consts("cpu")))
    return cfg, model, step, state


def _digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
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
                epoch: int = 30, lr: float = 1e-4, selections=None) -> dict:
    """``steps`` train steps of the global ``batch`` (this rank's stripe of
    it): every step's stats, the first step's gradients, then the
    parameters and running statistics (rank 0's; the other ranks return
    a digest of their parameters), the step count and the shape of every
    Adam moment this rank holds."""
    from pdfnet_tpu_torch.ops.sa import knn_plain
    rank, world = _where()
    cfg, model, step, state = build(cfg_kw, weights)
    local = stripe(batch, rank, world)
    knn, left = ((knn_plain, []) if selections is None else
                 _replaying(selections, batch["input"].shape[0]))
    stats, grads = [], None
    with _knn(knn):
        for _ in range(steps):
            s = step(state, local, epoch, lr)
            stats.append({k: float(v) for k, v in s.items()})
            if grads is None:
                grads = {n: (p.grad.clone() if p.grad is not None
                             else torch.zeros_like(p)).numpy()
                         for n, p in model.named_parameters()}
    assert not left, "selections left over"
    opt = state.optimizer
    leaves = [p for g in opt.param_groups for p in g["params"]]
    out = {"stats": stats, "digest": _digest(model), "step": state.step,
           "moments": {i: tuple(opt.state[p]["exp_avg"].shape)
                       for i, p in enumerate(leaves) if p in opt.state}}
    if rank == 0:
        out["grads"] = grads
        out["params"] = {n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()}
        out["buffers"] = {n: b.numpy().copy()
                          for n, b in model.named_buffers()
                          if n.endswith(("running_mean", "running_var"))}
    return out


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
