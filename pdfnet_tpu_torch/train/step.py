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
rank's part of a data-parallel step over the global batch, the ranks'
stripes in rank order: its forward runs inside ``mesh.global_batch`` (the
BatchNorm statistics and the loss's non-mean reductions of the whole
batch), the gradients and the stats are averaged over the ranks, and with
``zero1_opt_sharding`` the Adam moments are split over them
(``mesh.Zero1Adam``).  The result is one process's step on the global
batch, as the JAX step under GSPMD.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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

Batch = Dict[str, Any]


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
    statistics, and ``zero1_opt_sharding`` splits the moments over the
    ranks (``mesh.Zero1Adam``); in one process it changes nothing, as a
    one-device mesh replicates in JAX."""
    device = next(model.parameters()).device
    kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
              capturable=device.type == "cuda")
    if not mesh.is_distributed():
        return TrainState(model=model,
                          optimizer=torch.optim.Adam(model.parameters(), **kw))
    mesh.broadcast_tensors(list(model.parameters()) + _stat_buffers(model))
    opt = (mesh.Zero1Adam(model, **kw) if cfg.zero1_opt_sharding
           else torch.optim.Adam(model.parameters(), **kw))
    return TrainState(model=model, optimizer=opt)


def _stat_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for n, b in model.named_buffers()
            if n.endswith(mesh.STAT_BUFFERS)]


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


def _slices(batch: Dict[str, torch.Tensor], n: int, what: str
            ) -> List[Dict[str, torch.Tensor]]:
    """``n`` equal slices of the batch axis of every per-sample entry."""
    B = batch["input"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by {what}={n}")
    c = B // n
    cut = lambda v, i: v[i * c:(i + 1) * c] if v.dim() and v.shape[0] == B else v
    return [{k: cut(v, i) for k, v in batch.items()} for i in range(n)]


def _mean_stats(per: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    if len(per) == 1:
        return per[0]
    return {k: torch.stack([s[k] for s in per]).mean(0) for k in per[0]}


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
    layout = _rank_layout(groups, accum) if dp else _Layout(
        contextlib.nullcontext, groups, accum, False, None)
    groups, accum = layout.groups, layout.accum
    device = next(model.parameters()).device
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def norm_stats():
        return [(m.running_mean.clone(), m.running_var.clone()) for m in norms]

    def set_norm_stats(saved):
        for m, (mean, var) in zip(norms, saved):
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)

    def forward_loss(b, epoch, generator):
        result, params, hand_dicts, other = model(
            b["input"], b["choose"], b["cloud"], ind=b["ind"],
            generator=generator)
        return compute_loss(cfg, consts, result, params, hand_dicts, other,
                            b, epoch, mode="train")

    def train_step(state: TrainState, batch: Batch, epoch: int, lr: float,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        if not model.training:
            model.train()
        opt = state.optimizer
        b = _to_device(batch, device)
        opt.zero_grad(set_to_none=True)
        guard = cfg.skip_nonfinite_updates
        norms_before = (norm_stats() if guard or groups > 1 or layout.chunks
                        else None)
        per = []
        with layout.ctx():
            _forward_backward(b, epoch, generator, norms_before, per)
        stats = {k: v.detach() for k, v in _mean_stats(per).items()}
        if dp:
            mesh.all_reduce_grads(list(model.parameters()))
            stats = mesh.all_reduce_stats(stats)
            if layout.chunks:
                _chain_running_stats(norms, norms_before, layout.chunks)

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
                for m, (mean, var) in zip(norms, norms_before):
                    m.running_mean.copy_(torch.where(ok, m.running_mean, mean))
                    m.running_var.copy_(torch.where(ok, m.running_var, var))
            stats["skipped_nonfinite"] = (~ok).float()
        if layout.keep_rank0:
            # BatchNorm groups: group 0's statistics, which rank 0 holds
            mesh.broadcast_tensors(_stat_buffers(model))
        state.step += 1
        return stats

    def _forward_backward(b, epoch, generator, norms_before, per):
        if groups > 1:
            # Per-replica BatchNorm (DDP-of-G emulation, step.py:95-118):
            # each group normalizes with its own slice and starts from the
            # same running statistics; group 0's new statistics are kept.
            for i, bg in enumerate(_slices(b, groups, "bn_stat_groups")):
                if i:
                    set_norm_stats(norms_before)
                loss, stats = forward_loss(bg, epoch, generator)
                (loss / groups).backward()
                per.append(stats)
                if i == 0:
                    kept = norm_stats()
            set_norm_stats(kept)
        elif accum > 1:
            # sequential chunks against fixed parameters, gradients summed
            # then averaged (step.py:120-161); live BatchNorm statistics
            # carry from one chunk to the next
            for bc in _slices(b, accum, "grad_accum_steps"):
                loss, stats = forward_loss(bc, epoch, generator)
                loss.backward()
                per.append(stats)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        else:
            loss, stats = forward_loss(b, epoch, generator)
            loss.backward()
            per.append(stats)

    return train_step


class _Layout(NamedTuple):
    """How a rank of the process group takes its part of the global batch
    (``_rank_layout``)."""

    ctx: Callable                # the context of its forward and backward
    groups: int                  # the BatchNorm groups it runs itself
    accum: int                   # the accumulation chunks it runs itself
    keep_rank0: bool             # rank 0's running statistics are kept
    chunks: Optional[Tuple[int, int, int, int]]   # (A, first, own, ranks)


def _rank_layout(groups: int, accum: int) -> _Layout:
    """Under a process group, the global batch is the ranks' stripes in
    rank order, cut in rank order into ``bn_stat_groups=G`` groups or
    ``grad_accum_steps=A`` chunks.  A group or chunk inside one rank runs
    there on its own (no collective); one that spans whole ranks runs on
    each of them inside ``mesh.global_batch`` over those ranks (a group of
    its own, every rank creating every group in one order); any other cut
    raises.  Without either, the forward's batch is every rank's.  Kept
    are group 0's running statistics (rank 0's); the chunks' statistics
    follow one another, as JAX's scan carries them, which
    ``_chain_running_stats`` rebuilds from each rank's own chain."""
    world, rank = mesh.process_count(), mesh.process_index()
    cuts, what = (accum, "grad_accum_steps") if accum > 1 else (
        groups, "bn_stat_groups")
    if cuts <= 1:
        return _Layout(mesh.global_batch, groups, accum, False, None)
    if cuts % world == 0:
        own, span, first = cuts // world, 1, rank * (cuts // world)
        ctx = contextlib.nullcontext
    elif world % cuts == 0:
        own, span = 1, world // cuts
        first = rank // span
        subgroups = [dist.new_group(list(range(g * span, (g + 1) * span)))
                     for g in range(cuts)]
        ctx = lambda: mesh.global_batch(subgroups[first])   # noqa: E731
    else:
        raise ValueError(
            f"{what}={cuts} over {world} processes: a group must lie "
            f"inside one process or span whole processes")
    if accum > 1:
        return _Layout(ctx, groups, own, False, (accum, first, own, span))
    return _Layout(ctx, own, accum, True, None)


@torch.no_grad()
def _chain_running_stats(norms, before, chunks) -> None:
    """The running statistics after all A chunks of the global batch in
    order, from each rank's chain over its own: chunks ``first ..
    first + own - 1`` (``span`` ranks each running the same chunk) moved
    a statistic from r0 to R, so the ranks' ``m**(A - first - own) *
    (R - m**own * r0) / span`` add up to the global chain minus
    ``m**A * r0`` (m the norm's flax momentum).  Frozen norms stay."""
    A, first, own, span = chunks
    live = [(m, b) for m, b in zip(norms, before) if not m.frozen]
    parts = []
    for m, (mean0, var0) in live:
        mom = m.flax_momentum
        w = mom ** (A - first - own) / span
        parts += [(m.running_mean - mom ** own * mean0) * w,
                  (m.running_var - mom ** own * var0) * w]
    if not parts:
        return
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    sums = flat.split([p.numel() for p in parts])
    for k, (m, (mean0, var0)) in enumerate(live):
        mom = m.flax_momentum ** A
        m.running_mean.copy_(mom * mean0 + sums[2 * k])
        m.running_var.copy_(mom * var0 + sums[2 * k + 1])


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
    batch_ctx = mesh.global_batch if dp else contextlib.nullcontext

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
            mesh.all_reduce_grads(list(model.parameters()))
            stats = mesh.all_reduce_stats(stats)
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        state.step += 1
        return stats

    return train_step


def make_eval_step(cfg: Config, model: HandNet, consts: LossConsts
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """A callable on the bench's batch dict (``bench.py:57-68``: input,
    choose, cloud, K_new, ...; numpy arrays or tensors; only ``EVAL_KEYS``
    are moved to the device) that runs the model
    in eval mode under ``torch.inference_mode()`` on the model's device and
    returns ``eval_outputs``.  Returns before the device finishes, like any
    CUDA call; synchronize to time it."""
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

    return eval_step
