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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.csp import CSPNet
from pdfnet_tpu_torch.models.handnet import HandNet
from pdfnet_tpu_torch.models.layers import BatchNorm
from pdfnet_tpu_torch.train.loss import LossConsts, compute_loss, eval_outputs
from pdfnet_tpu_torch.train.mano_branch import ManoBranchConsts, csp_loss

Batch = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""

    model: HandNet | CSPNet
    optimizer: torch.optim.Adam
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
    CSP detector too (JAX ``create_csp_train_state``, ``step.py:213-224``)."""
    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8, capturable=device.type == "cuda")
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
        norms_before = norm_stats() if guard or groups > 1 else None
        per = []
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
        stats = {k: v.detach() for k, v in _mean_stats(per).items()}

        for g in opt.param_groups:
            g["lr"] = lr
        if not guard:
            opt.step()
        else:
            # a non-finite loss leaves parameters, optimizer state and
            # BatchNorm statistics as they were, decided on the device
            ok = torch.isfinite(stats["loss"])
            _guarded_update(opt, ok)
            with torch.no_grad():
                for m, (mean, var) in zip(norms, norms_before):
                    m.running_mean.copy_(torch.where(ok, m.running_mean, mean))
                    m.running_var.copy_(torch.where(ok, m.running_var, var))
            stats["skipped_nonfinite"] = (~ok).float()
        state.step += 1
        return stats

    return train_step


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
    stats as device tensors."""
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch: Batch, epoch: int, lr: float,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        del generator
        if not model.training:
            model.train()
        opt = state.optimizer
        b = _to_device(batch, device)
        opt.zero_grad(set_to_none=True)
        loss, stats = csp_loss(cfg, consts, model(b["input"], b["depth"]), b,
                               epoch)
        loss.backward()
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        state.step += 1
        return {k: v.detach() for k, v in stats.items()}

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
