"""Data parallelism over processes (port of ``pdfnet_tpu/parallel/mesh.py``
on ``torch.distributed``).

The reference trains with DDP over NCCL (main.py:69-75).  The JAX package
runs one jitted step over the global batch, sharded over a device mesh,
with GSPMD inserting the collectives.  The port runs one process a device:
each rank holds its stripe of the global batch (the loader stripes records
by rank, ``data/loader.py``) and a replicated copy of the model, and the
train step (``train/step.py``) makes the result the global batch's:

- ``global_batch`` puts the reductions that are not a plain mean over
  equal stripes over every rank of the batch's group (``batch_sum``,
  ``batch_gather``, with the gradient through the collective): the train
  BatchNorm's sums (``models/layers.py``), ``reg_l1_loss``'s masked count
  and the focal loss's batch-global guard (``train/loss.py``),
  ``hard_example_mining``'s top 70 % (``train/priors.py``);
- ``all_reduce_grads`` averages the gradients after the backward, and
  ``all_reduce_stats`` the logged stats;
- under ``Config.zero1_opt_sharding`` each rank holds and updates only its
  slice of the Adam moments (``Zero1Adam``, placed by
  ``zero1_state_shardings``) and the parameter slices are all-gathered.

With one device a process, ``make_mesh``, ``batch_sharding``,
``replicated``, ``shard_batch``, ``replicate`` and ``place_state`` have no
work: a rank's batch is its stripe as the loader gives it and its state is
its replicated copy, so the port has no such functions.  The 2-D (data x
model) layout (``make_mesh_2d``, ``shard_params_tp``) is not ported.

Every function here is the identity, or one process's answer, when no
process group is initialized.  When one is, the train step takes this path
at any world size, so a one-rank group runs the same collectives as N.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# the environment of torch's own rendezvous (``init_method="env://"``)
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def is_distributed() -> bool:
    """A process group is initialized (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device="cuda") -> bool:
    """The process group (the reference's ``dist.init_process_group``,
    main.py:69-75): NCCL when ``device`` is the card, gloo when it is the
    CPU.  ``coordinator`` ("host:port") with ``num_processes`` and
    ``process_id`` sets it up explicitly (``init_method="tcp://" +
    coordinator``); without it, torch's environment rendezvous is used when
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` are all
    set, and nothing happens otherwise.  Returns True when more than one
    process runs.  Safe to call twice (the second call only reports).  On
    the card the rank's device is made current first, and a torch without
    NCCL raises: nothing falls back to gloo."""
    if is_distributed():
        return dist.get_world_size() > 1
    explicit = coordinator is not None
    if not (explicit or all(k in os.environ for k in ENV_KEYS)):
        return False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        if not dist.is_nccl_available():
            raise RuntimeError("maybe_initialize_distributed: this torch has "
                               "no NCCL for a process group on the card")
        rank = process_id if explicit else int(os.environ["RANK"])
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = "nccl" if on_card else "gloo"
    if explicit:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size() > 1


def process_local_batch_size(global_batch: int) -> int:
    """Per-process slice of the global batch (the DistributedSampler role)."""
    P = process_count()
    if global_batch % P != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{P} processes")
    return global_batch // P


# ---- the global batch inside a train step -----------------------------------

class _BatchGroup:
    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank


_ACTIVE: Optional[_BatchGroup] = None


@contextlib.contextmanager
def global_batch(group=None) -> Iterator[None]:
    """Within the block, ``batch_sum``/``batch_gather``/``batch_stripe``
    reduce over the ranks of ``group`` (the default group when None): the
    ranks whose stripes make one batch, in rank order.  Every rank enters
    it around the same forward; collectives inside need every rank."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = _BatchGroup(group, dist.get_world_size(group),
                          dist.get_rank(group))
    try:
        yield
    finally:
        _ACTIVE = saved


class _AllSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient of every rank's output
    flows back to every rank's input (an all-reduce of the cotangents)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the batch in ``global_batch`` (the
    identity outside it), differentiable."""
    if _ACTIVE is None:
        return x
    return _AllSum.apply(x, _ACTIVE.group)


def batch_gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along dim 0
    in rank order, the global batch's rows; ``x`` itself outside
    ``global_batch``.  Differentiable: each rank's rows get the gradient
    of every rank's use of them."""
    if _ACTIVE is None:
        return x
    n, r = _ACTIVE.size, _ACTIVE.rank
    full = x.new_zeros((n * x.shape[0],) + tuple(x.shape[1:]))
    full = full.index_copy(0, torch.arange(r * x.shape[0],
                                           (r + 1) * x.shape[0],
                                           device=x.device), x)
    return _AllSum.apply(full, _ACTIVE.group)


def batch_stripe() -> tuple:
    """(ranks in the batch, this rank's place among them); (1, 0) outside
    ``global_batch``."""
    return (1, 0) if _ACTIVE is None else (_ACTIVE.size, _ACTIVE.rank)


# ---- after the backward ------------------------------------------------------

def _unflatten_into(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy consecutive pieces of ``flat`` into ``tensors``: views cut in
    C++ and one multi-tensor copy, not a launch and a Python view a
    tensor."""
    torch._foreach_copy_(tensors, _unflatten_dense_tensors(flat, tensors))


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Average ``.grad`` over every rank (DDP's all-reduce, in one flat
    buffer).  A parameter without a gradient has none on any rank: the
    ranks run one graph."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    _unflatten_into(grads, flat)


def all_reduce_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over every rank of each scalar stat: the global batch's
    value (each rank's is its stripe's mean, or already global)."""
    keys = sorted(stats)
    vec = torch.stack([stats[k].float().reshape(()) for k in keys])
    dist.all_reduce(vec)
    vec = vec / dist.get_world_size()
    return {k: vec[i] for i, k in enumerate(keys)}


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Every rank takes rank ``src``'s values of ``tensors`` (float32),
    in place."""
    tensors = [t.detach() for t in tensors]
    if not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.broadcast(flat, src)
    _unflatten_into(tensors, flat)


# ---- ZeRO-1: the Adam moments sharded over the ranks -------------------------

def _flax_leading_dim(module: torch.nn.Module, leaf: str) -> int:
    """The dim of the port's tensor that is the leading axis of the flax
    leaf it stands for (``convert.py``'s layouts): a Conv2d kernel is OIHW
    for HWIO and a transposed one (I, O, kh, kw) for (kh, kw, I, O), so H
    is dim 2; a Linear kernel is (O, I) for (I, O), so I is dim 1."""
    from pdfnet_tpu_torch.models.layers import StridedUpConv
    if leaf == "weight":
        if isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                               StridedUpConv)):
            return 2
        if isinstance(module, torch.nn.Linear):
            return 1
    return 0


def zero1_state_shardings(model: torch.nn.Module, world: int,
                          min_elems: int = 2 ** 14) -> List[Optional[int]]:
    """ZeRO-1 placement (``zero1_state_shardings``, JAX's rule): for each
    of ``model.parameters()``, the dim of its Adam moments that is split
    over the ``world`` ranks, or None where they are replicated.  A moment
    is split along flax's leading axis when that axis divides by ``world``
    and it holds at least ``min_elems`` elements, so the same leaves are
    split as in JAX, along the same axis."""
    owners = {}
    for mname, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            owners[id(p)] = (module, leaf)
    out = []
    for p in model.parameters():
        module, leaf = owners[id(p)]
        d = _flax_leading_dim(module, leaf) if p.dim() >= 1 else None
        out.append(d if d is not None and p.dim() > d
                   and p.shape[d] % world == 0 and p.numel() >= min_elems
                   else None)
    return out


class Zero1Adam:
    """``torch.optim.Adam`` over every parameter with each rank holding
    only its slice of the split moments (``zero1_state_shardings``).  For
    a split parameter the inner Adam updates a slice of it (a leaf of its
    own, refreshed from the parameter each step) with the slice of its
    averaged gradient; then the slices are all-gathered into every rank's
    parameter.  Adam's arithmetic is elementwise, so the update is the
    replicated optimizer's.  ``state_dict`` (collective) and
    ``load_state_dict`` speak the replicated optimizer's format: one
    checkpoint serves any number of ranks."""

    def __init__(self, model: torch.nn.Module, **adam_kwargs):
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.params = list(model.parameters())
        self.dims = zero1_state_shardings(model, self.world)
        self.leaves = [p if d is None else
                       self._slice(p, d).detach().clone()
                       for p, d in zip(self.params, self.dims)]
        self.inner = torch.optim.Adam(self.leaves, **adam_kwargs)

    def _slice(self, t: torch.Tensor, d: int, rank: Optional[int] = None):
        s = t.shape[d] // self.world
        return t.narrow(d, (self.rank if rank is None else rank) * s, s)

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, update=None) -> None:
        """One update from the parameters' (averaged) gradients:
        ``update(inner)`` runs the inner Adam (``inner.step()`` when
        None), then the split parameters are all-gathered."""
        split = [(p, d, q) for p, d, q in zip(self.params, self.dims,
                                              self.leaves) if d is not None]
        if split:
            torch._foreach_copy_([q for _, _, q in split],
                                 [self._slice(p, d) for p, d, _ in split])
        for p, d, q in split:
            q.grad = (None if p.grad is None
                      else self._slice(p.grad, d).contiguous())
        (update or (lambda o: o.step()))(self.inner)
        if not split:
            return
        flat = _flatten_dense_tensors([q for _, _, q in split])
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        dist.all_gather(parts, flat)
        for r, part in enumerate(parts):
            _unflatten_into([self._slice(p, d, r) for p, d, _ in split], part)

    def state_dict(self) -> dict:
        """The replicated optimizer's ``state_dict``: every split moment
        all-gathered along its dim.  Collective: every rank calls it."""
        sd = self.inner.state_dict()
        state = {i: dict(s) for i, s in sd["state"].items()}
        keys = [(i, k) for i, d in enumerate(self.dims) if d is not None
                and i in state for k in ("exp_avg", "exp_avg_sq")]
        if keys:
            flat = torch.cat([state[i][k].reshape(-1) for i, k in keys])
            parts = [torch.empty_like(flat) for _ in range(self.world)]
            dist.all_gather(parts, flat)
            sizes = [state[i][k].numel() for i, k in keys]
            pieces = [part.split(sizes) for part in parts]
            for j, (i, k) in enumerate(keys):
                shape = state[i][k].shape
                state[i][k] = torch.cat([pieces[r][j].view(shape)
                                         for r in range(self.world)],
                                        dim=self.dims[i])
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        """Take the replicated optimizer's ``state_dict``: each rank keeps
        its slice of the split moments."""
        state = {}
        for i, s in sd["state"].items():
            s, d = dict(s), self.dims[int(i)]
            if d is not None:
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in s:
                        s[k] = self._slice(s[k], d).contiguous()
            state[i] = s
        self.inner.load_state_dict({"state": state,
                                    "param_groups": sd["param_groups"]})


# ---- host copies ---------------------------------------------------------------

def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


STAT_BUFFERS = ("running_mean", "running_var")


def gather_to_host(state) -> dict:
    """A host copy of a train state (``model``, ``optimizer``, ``step``)
    in the one-process checkpoint format: ``params``, ``batch_stats``
    (every BatchNorm's running statistics), ``opt_state`` (the replicated
    Adam's ``state_dict``) and ``step``.  COLLECTIVE when the optimizer
    state is split (``Zero1Adam``): every rank must call it."""
    model = state.model
    return {"params": {n: _to_cpu(p) for n, p in model.named_parameters()},
            "batch_stats": {n: _to_cpu(b) for n, b in model.named_buffers()
                            if n.endswith(STAT_BUFFERS)},
            "opt_state": _to_cpu(state.optimizer.state_dict()),
            "step": int(state.step)}
