"""Train and eval steps (port of ``pdfnet_tpu/train/step.py``: ``TrainState``,
``lr_at_epoch``, ``create_train_state``, ``make_train_step``,
``make_eval_step``, and the CSP detector's ``make_csp_train_step``, whose
state ``create_train_state`` makes).

One train step is forward in training mode, ``compute_loss``, backward and
one Adam update, with the options of the JAX step: gradient accumulation
(``grad_accum_steps``), per-replica BatchNorm groups (``bn_stat_groups``),
frozen BatchNorm (``freeze_bn_stats``, read by the model) and the on-device
non-finite guard (``skip_nonfinite_updates``).  Nothing in a step reads a
device value on the host: the stats it returns are device tensors.

When a process group is initialized (``parallel.mesh``), a step is one
rank's part of a data-parallel step over the global batch, the data ranks'
stripes in data order (every rank a data rank, or the data index of a 2-D
layout, ``mesh.make_mesh_2d``): its forward runs inside
``mesh.global_batch`` over the data group (the BatchNorm statistics and the
loss's non-mean reductions of the whole batch), the gradients and the
stats are averaged over the data group, and with ``zero1_opt_sharding``
the Adam moments are split over the ranks (``mesh.Zero1Adam``).  Under a
2-D layout the model split by ``mesh.shard_params_tp`` runs its own
collectives over the model group, and the model peers' replicated
gradients and statistics are averaged over it (``mesh.sync_model_peers``).
The result is one process's step on
the global batch, as the JAX step under GSPMD.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.csp import CSPNet
from pdfnet_tpu_torch.models.handnet import HandNet
from pdfnet_tpu_torch.models.layers import BatchNorm
from pdfnet_tpu_torch.parallel import mesh
from pdfnet_tpu_torch.train.loss import LossConsts, compute_loss, eval_outputs
from pdfnet_tpu_torch.train.mano_branch import ManoBranchConsts, csp_loss
from pdfnet_tpu_torch.utils.precision import float32_precision

Batch = Dict[str, Any]


def _in_precision(cfg: Config, step: Callable) -> Callable:
    """``step`` run with TF32 off when ``cfg.compute_dtype`` is float32
    (its convolutions and matmuls, forward and backward), the caller's
    flags restored after."""
    @functools.wraps(step)
    def run(*args, **kwargs):
        with float32_precision(cfg.compute_dtype):
            return step(*args, **kwargs)
    return run


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""

    model: HandNet | CSPNet
    optimizer: torch.optim.Adam | mesh.Zero1Adam
    step: int = 0


def lr_at_epoch(cfg: Config, epoch: int) -> float:
    """Step-decay schedule: x0.1 at each lr_step boundary (main.py:137-143)."""
    lr = cfg.lr
    for s in cfg.lr_step:
        if epoch >= s:
            lr *= 0.1
    return lr


def create_train_state(cfg: Config, model: HandNet | CSPNet) -> TrainState:
    """Adam over every parameter with optax's defaults (betas 0.9/0.999,
    eps 1e-8 added outside the square root, no weight decay) at ``cfg.lr``.
    On the card its step counts stay on the device (``capturable``), so the
    non-finite guard can restore them without a host sync.  It serves the
    CSP detector too (JAX ``create_csp_train_state``, ``step.py:213-224``).

    In a process group every rank takes rank 0's parameters and BatchNorm
    statistics (the slices split by ``mesh.shard_params_tp`` were cut
    from rank 0's whole tree there), and ``zero1_opt_sharding`` splits the
    moments over the ranks (``mesh.Zero1Adam``; refused under a model axis
    > 1, as JAX's ``zero1_state_shardings`` pins the parameters
    replicated); in one process it changes nothing, as a one-device mesh
    replicates in JAX."""
    device = next(model.parameters()).device
    kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
              capturable=device.type == "cuda")
    layout = mesh.current_mesh()
    if cfg.zero1_opt_sharding and layout.model > 1:
        raise ValueError(
            f"zero1_opt_sharding under a model axis of {layout.model}: the "
            "ZeRO-1 placement keeps the parameters replicated, so it does "
            "not compose with shard_params_tp (as in JAX)")
    if not mesh.is_distributed():
        return TrainState(model=model,
                          optimizer=torch.optim.Adam(model.parameters(), **kw))
    shards = {id(t) for t in mesh.shard_tensors(model)}
    mesh.broadcast_tensors([p for p in model.parameters()
                            if id(p) not in shards]
                           + mesh.stat_buffers(model))
    opt = (mesh.Zero1Adam(model, **kw) if cfg.zero1_opt_sharding
           else torch.optim.Adam(model.parameters(), **kw))
    return TrainState(model=model, optimizer=opt)


# keys of a dataset batch that only the host reads (the metrics' padding
# mask and the submission's ids): never copied to the device
HOST_KEYS = frozenset(("id", "frame_num", "pad_mask", "file_id"))
# what the eval step reads: the model's inputs and eval_outputs' ground truth
EVAL_KEYS = ("input", "choose", "cloud", "K_new", "verts_left_gt",
             "verts_right_gt", "joints_left_gt", "joints_right_gt")


def _to_device(batch: Batch, device: torch.device,
               keys=None) -> Dict[str, torch.Tensor]:
    """The batch's ``keys`` (every key but ``HOST_KEYS`` by default) as
    tensors on ``device``."""
    if keys is None:
        keys = [k for k in batch if k not in HOST_KEYS]
    t = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    return {k: t(batch[k]).to(device, non_blocking=True) for k in keys
            if k in batch}


def make_train_step(cfg: Config, model: HandNet, consts: LossConsts
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, batch, epoch, lr, generator=None) -> stats``: one
    update of ``state`` in place.

    ``batch`` is the dataset dict (numpy arrays or tensors; ``ind`` the
    ground-truth centers), ``epoch`` an int (the loss's epoch gate), ``lr``
    the learning rate of this step (set on the optimizer per call, as
    ``optax.inject_hyperparams`` does), ``generator`` a ``torch.Generator``
    on the model's device for dropout.  Returns the loss stats as device
    tensors, averaged over accumulation chunks or BatchNorm groups.  After
    the call every parameter's ``.grad`` holds the gradient the update used
    (``None`` where the loss does not reach the parameter; the JAX step's
    gradient there is zero).
    """
    groups = max(int(cfg.bn_stat_groups or 0), 0)
    accum = max(int(cfg.grad_accum_steps or 1), 1)
    if accum > 1 and groups > 1:
        raise ValueError("grad_accum_steps and bn_stat_groups are mutually "
                         "exclusive (both re-slice the batch axis)")
    dp = mesh.is_distributed()
    layout = mesh.current_mesh() if dp else None
    cuts, what = ((accum, "grad_accum_steps") if accum > 1
                  else (max(groups, 1), "bn_stat_groups"))
    device = next(model.parameters()).device
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    plans: Dict[int, List[_Cut]] = {}

    def train_step(state: TrainState, batch: Batch, epoch: int, lr: float,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        if not model.training:
            model.train()
        opt = state.optimizer
        b = _to_device(batch, device)
        B = b["input"].shape[0] * (layout.data if dp else 1)
        if B not in plans:
            plans[B] = _rank_cuts(B, cuts, what, layout)
        opt.zero_grad(set_to_none=True)
        guard = cfg.skip_nonfinite_updates
        before = _norm_stats(norms) if guard or groups > 1 or accum > 1 \
            else None

        def loss_of(bc):
            result, params, hand_dicts, other = model(
                bc["input"], bc["choose"], bc["cloud"], ind=bc["ind"],
                generator=generator)
            return compute_loss(cfg, consts, result, params, hand_dicts,
                                other, bc, epoch, mode="train")

        stats = _run_cuts(model, plans[B], b, loss_of, groups > 1, before,
                         layout)
        for g in opt.param_groups:
            g["lr"] = lr
        if not guard:
            opt.step()
        else:
            # a non-finite loss (the global batch's) leaves parameters,
            # optimizer state and BatchNorm statistics as they were,
            # decided on the device
            ok = torch.isfinite(stats["loss"])
            if isinstance(opt, mesh.Zero1Adam):
                opt.step(lambda inner: _guarded_update(inner, ok))
            else:
                _guarded_update(opt, ok)
            with torch.no_grad():
                for m, (mean, var) in zip(norms, before):
                    m.running_mean.copy_(torch.where(ok, m.running_mean, mean))
                    m.running_var.copy_(torch.where(ok, m.running_var, var))
            stats["skipped_nonfinite"] = (~ok).float()
        state.step += 1
        return stats

    return _in_precision(cfg, train_step)


def _norm_stats(norms: List[BatchNorm]) -> List[tuple]:
    return [(m.running_mean.clone(), m.running_var.clone()) for m in norms]


@torch.no_grad()
def _set_norm_stats(norms: List[BatchNorm], saved: List[tuple]) -> None:
    for m, (mean, var) in zip(norms, saved):
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)


def _run_cuts(model: torch.nn.Module, plan: List["_Cut"], b: Batch,
             loss_of: Callable, groups: bool, before: Optional[List[tuple]],
             layout: Optional[mesh.Layout]) -> Dict[str, torch.Tensor]:
    """The forward and backward of a train step over the cuts of ``plan``
    (``_rank_cuts``), before its update: each cut's rows of ``b`` (a dict
    of tensors, rows along dim 0 of ``b["input"]``) through ``loss_of``
    (-> loss, stats) in the cut's context, its loss divided by the cut's
    scale (sequential chunks or groups against fixed parameters, their
    gradients summed to the mean over the cuts, ``step.py:95-161``);
    with ``groups`` each BatchNorm group starts from the running
    statistics ``before`` the step (per-replica BatchNorm, the DDP-of-G
    emulation) and group 0's are kept.  In a process group (``layout``;
    None in one process) the gradients and the stats are then averaged
    over the data group, the chunks' running statistics chained over it
    (``_chain_running_stats``), the groups' taken from data rank 0 (group
    0's), and under a 2-D layout the model peers' replicated gradients and
    statistics made one replica (``mesh.sync_model_peers``).  ``before``
    is needed with ``groups`` and with more than one chunk.  Returns the
    stats, each cut's divided by its scale and summed."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    rows = b["input"].shape[0]
    chain = (layout is not None and layout.data > 1 and not groups
             and plan[0].of > 1)
    per, moves = [], []
    for i, cut in enumerate(plan):
        bc = b if cut.rows == slice(0, rows) else {
            k: v[cut.rows] if v.dim() and v.shape[0] == rows else v
            for k, v in b.items()}
        if groups and i:
            _set_norm_stats(norms, before)
        start = _norm_stats(norms) if chain else None
        with cut.ctx():
            loss, stats = loss_of(bc)
            (loss / cut.scale).backward()
        per.append(stats)
        if chain:
            moves.append((cut.index, cut.ranks, start, _norm_stats(norms)))
        if groups and i == 0:
            kept = _norm_stats(norms)
    if groups:
        _set_norm_stats(norms, kept)
    stats = {k: sum(s[k].detach() / c.scale for s, c in zip(per, plan))
             for k in per[0]}
    if layout is None:
        return stats
    mesh.all_reduce_grads(list(model.parameters()), layout.data_group)
    stats = mesh.all_reduce_stats(stats, layout.data_group)
    if chain:
        _chain_running_stats(norms, before, moves, plan[0].of,
                             layout.data_group)
    if groups and layout.data > 1:
        mesh.broadcast_tensors(mesh.stat_buffers(model),
                               layout.data_ranks[0], layout.data_group)
    if layout.model > 1:
        mesh.sync_model_peers(model, layout,
                              any(not m.frozen for m in norms))
    return stats


class _Cut(NamedTuple):
    """One BatchNorm group or accumulation chunk of the global batch, as a
    rank runs it (``_rank_cuts``)."""

    index: int          # c, the cut's place in the global batch
    rows: slice         # this rank's rows of it, in its stripe
    ctx: Callable       # the context of its forward and backward
    ranks: int          # the data ranks holding rows of it
    scale: float        # R / rows: the divisor of this rank's loss of it
    of: int             # the cuts of the global batch


def _rank_cuts(B: int, cuts: int, what: str,
               layout: Optional[mesh.Layout]) -> List[_Cut]:
    """The cuts of the global batch of ``B`` rows (``bn_stat_groups=G``
    groups or ``grad_accum_steps=A`` chunks, ``cuts`` of them) that this
    rank runs, in ascending order.  Data rank d holds rows ``[d R, (d+1)
    R)``, R = B / D over D data ranks (``layout``; None in one process);
    cut c is rows ``[c S, (c+1) S)``, S = B / cuts.  Each rank runs every
    cut that has rows on it, on its own rows of the cut.  A cut held by one
    rank runs with no collective; one held by several runs inside
    ``mesh.global_batch`` over a group of exactly those ranks (their row
    counts given), every rank creating every such group in one order
    (``dist.new_group``: for each cut, for each model index); the whole
    batch (one cut) over the data group.  A rank's loss of a cut is divided
    by R / its rows there, so that the gradients' average over the data
    ranks is one process's mean over the cuts: ``sum_c grad L_c / cuts``,
    a BatchNorm's sums and the loss's global reductions included (their
    gradient reaches every holder through the collective)."""
    if B % cuts:
        raise ValueError(f"batch {B} not divisible by {what}={cuts}")
    D = 1 if layout is None else layout.data
    d = 0 if layout is None else layout.data_index
    R, S = B // D, B // cuts
    out = []
    for c in range(cuts):
        lo, hi = c * S, (c + 1) * S
        holders = range(lo // R, (hi - 1) // R + 1)
        counts = [min(hi, (h + 1) * R) - max(lo, h * R) for h in holders]
        ctx = contextlib.nullcontext
        if layout is not None and cuts == 1:
            ctx = functools.partial(mesh.global_batch, layout.data_group,
                                    counts)
        elif len(holders) > 1:
            for m in range(layout.model):
                group = dist.new_group([layout.data_ranks_of(m)[h]
                                        for h in holders])
                if m == layout.model_index:
                    ctx = functools.partial(mesh.global_batch, group, counts)
        if d in holders:
            first = max(lo, d * R) - d * R
            n = counts[d - holders[0]]
            out.append(_Cut(c, slice(first, first + n), ctx, len(holders),
                            R / n, cuts))
    return out


@torch.no_grad()
def _chain_running_stats(norms, r0, moves, A: int, group) -> None:
    """The running statistics after all A chunks of the global batch in
    order, as JAX's scan carries them, from each rank's chunks: chunk c
    moved a statistic from R_before to R_after = m R_before + (1 - m) x_c
    (m the norm's flax momentum, x_c the chunk's global batch statistic),
    so the ranks' ``sum_c m**(A - 1 - c) (R_after - m R_before) / n_c``
    (n_c ranks hold chunk c) add up, over the data group, to the global
    chain minus ``m**A r0``.  Frozen norms stay."""
    live = [k for k, m in enumerate(norms) if not m.frozen]
    if not live:
        return
    parts = []
    for k in live:
        mom = norms[k].flax_momentum
        for j in (0, 1):
            parts.append(sum(mom ** (A - 1 - c) * (after[k][j]
                                                   - mom * before[k][j]) / n
                             for c, n, before, after in moves))
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    sums = flat.split([p.numel() for p in parts])
    for i, k in enumerate(live):
        m = norms[k]
        mom = m.flax_momentum ** A
        m.running_mean.copy_(mom * r0[k][0] + sums[2 * i])
        m.running_var.copy_(mom * r0[k][1] + sums[2 * i + 1])


@torch.no_grad()
def _guarded_update(opt: torch.optim.Optimizer, ok: torch.Tensor) -> None:
    """``opt.step()``, then every parameter and optimizer-state tensor it
    touched is put back where ``ok`` (a 0-d device bool) is false; state
    the step created is put back to its initial zeros."""
    params = [p for g in opt.param_groups for p in g["params"]
              if p.grad is not None]
    old = [p.clone() for p in params]
    old_state = {p: {k: v.clone() for k, v in opt.state[p].items()
                     if torch.is_tensor(v)} for p in params if p in opt.state}
    opt.step()
    for p, o in zip(params, old):
        p.copy_(torch.where(ok, p, o))
        prev = old_state.get(p, {})
        for k, v in opt.state[p].items():
            if torch.is_tensor(v):
                v.copy_(torch.where(ok, v, prev.get(k, torch.zeros_like(v))))


def make_csp_train_step(cfg: Config, model: CSPNet, consts: ManoBranchConsts
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, batch, epoch, lr, generator=None) -> stats`` for the
    CSP detector (JAX ``make_csp_train_step``, ``step.py:227-257``): the
    model in training mode on ``input`` and ``depth`` (its BatchNorm
    statistics update), ``csp_loss`` with ``epoch`` (the origforward
    ``alpha`` gate), backward and one Adam update at ``lr``.  There is no
    dropout, so ``generator`` is unused; like the JAX step it takes no
    accumulation, BatchNorm groups or non-finite guard.  Returns the loss
    stats as device tensors.  In a process group it is one rank's part of
    the global batch's step, as ``make_train_step``'s."""
    device = next(model.parameters()).device
    dp = mesh.is_distributed()
    layout = mesh.current_mesh()
    if layout.model > 1:
        raise ValueError(
            f"the CSP detector's train step under a model axis of "
            f"{layout.model}: tensor parallelism is ported for HandNet only")
    batch_ctx = (functools.partial(mesh.global_batch, layout.data_group)
                 if dp else contextlib.nullcontext)

    def train_step(state: TrainState, batch: Batch, epoch: int, lr: float,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        del generator
        if not model.training:
            model.train()
        opt = state.optimizer
        b = _to_device(batch, device)
        opt.zero_grad(set_to_none=True)
        with batch_ctx():
            loss, stats = csp_loss(cfg, consts, model(b["input"], b["depth"]),
                                   b, epoch)
            loss.backward()
        stats = {k: v.detach() for k, v in stats.items()}
        if dp:
            mesh.all_reduce_grads(list(model.parameters()), layout.data_group)
            stats = mesh.all_reduce_stats(stats, layout.data_group)
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        state.step += 1
        return stats

    return _in_precision(cfg, train_step)


def make_eval_step(cfg: Config, model: HandNet, consts: LossConsts
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """A callable on the bench's batch dict (``bench.py:57-68``: input,
    choose, cloud, K_new, ...; numpy arrays or tensors; only ``EVAL_KEYS``
    are moved to the device) that runs the model
    in eval mode under ``torch.inference_mode()`` on the model's device and
    returns ``eval_outputs``.  In float32 its convolutions and matmuls run
    with TF32 off (the train steps' too, backward included).  Returns
    before the device finishes, like any CUDA call; synchronize to time
    it."""
    device = next(model.parameters()).device

    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        if model.training:
            model.eval()
        with torch.inference_mode():
            b = _to_device(batch, device, EVAL_KEYS)
            result, params, hand_dicts, other = model(
                b["input"], b["choose"], b["cloud"])
            return eval_outputs(cfg, consts, result, params, hand_dicts,
                                other, b)

    return _in_precision(cfg, eval_step)
