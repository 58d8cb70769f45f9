"""Data and tensor parallelism over processes (port of
``pdfnet_tpu/parallel/mesh.py`` on ``torch.distributed``).

The reference trains with DDP over NCCL (main.py:69-75).  The JAX package
runs one jitted step over the global batch, sharded over a device mesh,
with GSPMD inserting the collectives.  The port runs one process a device:
each rank holds its stripe of the global batch (the loader stripes records
by rank, ``data/loader.py``) and a copy of the model, and the train step
(``train/step.py``) makes the result the global batch's:

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

The 2-D (data x model) layout (``make_mesh_2d``, ``shard_params_tp``) adds
tensor parallelism: world rank r is (r // model, r % model), the batch is
striped over the data index and every large parameter is split over the
model index on flax's last axis (``tp_plan``).  Every reduction over the
batch above then runs over the rank's data group (the ranks with its model
index), never over the world, which would count each row ``model`` times.
Inside the model (``_column_forward``) a Linear, Conv2d, ConvTranspose2d
or StridedUpConv with a split weight computes its slice of the output
channels (with its slice of the replicated bias) from the replicated input
and all-gathers them over the model group; the input's and the bias's
gradients are all-reduced over the model group.  Any other read of a split
leaf (``pos_emb``, the weight folds that feed the point-MLP and bottleneck
kernels, a patch head's ``F.conv2d``) sees the all-gathered tensor (a
``torch.nn.utils.parametrize`` parametrization whose stored ``original``
is the rank's slice; its backward keeps the slice's gradient).  The model
peers of a data rank compute the same replicated values, bit for bit.

With one device a process, ``make_mesh``, ``batch_sharding``,
``replicated``, ``shard_batch``, ``replicate`` and ``place_state`` have no
work: a rank's batch is its stripe as the loader gives it and its state is
its copy, so the port has no such functions.

Every function here is the identity, or one process's answer, when no
process group is initialized.  When one is, the train step takes this path
at any world size, so a one-rank group runs the same collectives as N.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import types
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.nn.utils import parametrize

# the environment of torch's own rendezvous (``init_method="env://"``)
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# JAX ``shard_params_tp``'s ``min_dim``: the smallest last axis it splits
TP_MIN_DIM = 256


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


# ---- the (data x model) layout -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in a (data x model) layout of the process group
    (``make_mesh_2d``), or in the 1-D data-parallel one (``model == 1``,
    the data group the default group: ``current_mesh`` without a 2-D
    mesh).  ``data_group`` holds the ranks of this rank's model index in
    data order (``data_ranks``, world ranks), ``model_group`` those of its
    data index in model order; a group of None is the default group."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None

    def data_ranks_of(self, model_index: int) -> List[int]:
        """The world ranks, in data order, of the data group of
        ``model_index``."""
        return [d * self.model + model_index for d in range(self.data)]

    @property
    def data_ranks(self) -> List[int]:
        return self.data_ranks_of(self.model_index)


_MESH: Optional[Tuple[Any, Layout]] = None   # (default group, its 2-D mesh)


def current_mesh() -> Layout:
    """The layout the train step reduces over: the last ``make_mesh_2d``'s
    on the process group it was made on, else every rank a data rank."""
    if _MESH is not None and is_distributed() and _MESH[0] is dist.group.WORLD:
        return _MESH[1]
    world, rank = process_count(), process_index()
    return Layout(world, 1, rank, 0)


def make_mesh_2d(data: int, model: int) -> Layout:
    """The (data x model) layout of the initialized process group, which
    becomes the process's mesh (``current_mesh``).  World rank r is
    ``(r // model, r % model)``: the model axis is innermost, as JAX
    reshapes ``devices[:data * model]`` to ``(data, model)``.  Every rank
    creates every data and model group, in one order (``dist.new_group``).
    A world of another size raises: fewer ranks with JAX's message, more
    because a rank outside the mesh would have no part in a step.
    COLLECTIVE: every rank calls it."""
    world = process_count()
    if world < data * model:
        raise ValueError(
            f"make_mesh_2d({data}, {model}) needs {data * model} devices, "
            f"have {world}")
    if world > data * model:
        raise ValueError(
            f"make_mesh_2d({data}, {model}) covers {data * model} of the "
            f"{world} processes: a rank outside the mesh would have no "
            f"part in a step")
    global _MESH
    d, m = divmod(process_index(), model)
    data_groups = [dist.new_group([dd * model + mm for dd in range(data)])
                   for mm in range(model)]
    model_groups = [dist.new_group([dd * model + mm for mm in range(model)])
                    for dd in range(data)]
    layout = Layout(data, model, d, m, data_groups[m], model_groups[d])
    _MESH = (dist.group.WORLD, layout)
    return layout


# ---- the global batch inside a train step -----------------------------------

class _BatchGroup:
    def __init__(self, group, counts: Optional[Sequence[int]]):
        self.group = group
        self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.counts = None if counts is None else list(counts)


_ACTIVE: Optional[_BatchGroup] = None


@contextlib.contextmanager
def global_batch(group=None, counts: Optional[Sequence[int]] = None
                 ) -> Iterator[None]:
    """Within the block, ``batch_sum``/``batch_gather``/``batch_stripe``
    reduce over the ranks of ``group`` (the default group when None): the
    ranks whose rows make one batch, in group order.  ``counts`` gives
    each member's rows in that order (equal stripes when None).  Every
    member enters it around the same forward; collectives inside need
    every member."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = _BatchGroup(group, counts)
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


def batch_stripe(rows: int) -> Tuple[int, int]:
    """(this rank's first row in the batch, the batch's rows) along dim 0
    of a tensor of which this rank holds ``rows`` rows: its samples' rows,
    the same number a sample on every rank (hands or points folded into
    dim 0, sample-major); ``(0, rows)`` outside ``global_batch``."""
    a = _ACTIVE
    if a is None:
        return 0, rows
    if a.counts is None:
        return a.rank * rows, a.size * rows
    per = rows // a.counts[a.rank]
    return per * sum(a.counts[:a.rank]), per * sum(a.counts)


def batch_gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in group order, each
    rank's rows at its offset (``batch_stripe``): the batch's rows; ``x``
    itself outside ``global_batch``.  Differentiable: each rank's rows get
    the gradient of every rank's use of them."""
    if _ACTIVE is None:
        return x
    first, total = batch_stripe(x.shape[0])
    full = x.new_zeros((total,) + tuple(x.shape[1:]))
    full = full.index_copy(0, torch.arange(first, first + x.shape[0],
                                           device=x.device), x)
    return _AllSum.apply(full, _ACTIVE.group)


# ---- after the backward ------------------------------------------------------

def _unflatten_into(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy consecutive pieces of ``flat`` into ``tensors``: views cut in
    C++ and one multi-tensor copy, not a launch and a Python view a
    tensor."""
    torch._foreach_copy_(tensors, _unflatten_dense_tensors(flat, tensors))


@torch.no_grad()
def average_tensors(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each of ``tensors`` replaced by its mean over the ranks of ``group``
    (the default group when None), in one flat buffer."""
    tensors = [t.detach() for t in tensors]
    if not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    _unflatten_into(tensors, flat)


def all_reduce_grads(params: Sequence[torch.Tensor], group=None) -> None:
    """Average ``.grad`` over the ranks of ``group`` (the default group
    when None; the data group of a 2-D layout), DDP's all-reduce.  A
    parameter without a gradient has none on any rank: the ranks run one
    graph."""
    average_tensors([p.grad for p in params if p.grad is not None], group)


def sync_model_peers(model: nn.Module, layout: Layout, stats: bool) -> None:
    """The replicated leaves' gradients (and with ``stats`` the BatchNorm
    running statistics) averaged over the model group, so that the model
    peers of a data rank hold one replica, as GSPMD keeps one value for a
    replicated leaf: they compute it alike, but the card's float32 atomic
    sums may leave their copies a rounding apart.  Exact where the peers
    agree (the mean of equal values)."""
    shards = {id(t) for t in shard_tensors(model)}
    tensors = [p.grad for p in model.parameters()
               if id(p) not in shards and p.grad is not None]
    average_tensors(tensors + (stat_buffers(model) if stats else []),
                    layout.model_group)


def all_reduce_stats(stats: Dict[str, torch.Tensor], group=None
                     ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of ``group`` (the default group when None)
    of each scalar stat: the global batch's value (each rank's is its
    stripe's mean, or already global)."""
    keys = sorted(stats)
    vec = torch.stack([stats[k].float().reshape(()) for k in keys])
    dist.all_reduce(vec, group=group)
    vec = vec / dist.get_world_size(group)
    return {k: vec[i] for i, k in enumerate(keys)}


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0,
                      group=None) -> None:
    """Every rank of ``group`` (the default group when None) takes world
    rank ``src``'s values of ``tensors`` (float32), in place."""
    tensors = [t.detach() for t in tensors]
    if not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.broadcast(flat, src, group=group)
    _unflatten_into(tensors, flat)


# ---- tensor parallelism: the model axis of a 2-D layout -----------------------

def tp_plan(model: nn.Module, parts: int) -> Dict[str, int]:
    """JAX ``shard_params_tp``'s rule in the port's layout: {parameter name:
    the dim split over ``parts`` model ranks} for every parameter whose
    flax leaf (``convert.flax_last_dim``) has ndim >= 2 and a last axis of
    at least ``TP_MIN_DIM`` that ``parts`` divides.  The other parameters
    (biases, norms, small kernels) stay replicated."""
    from pdfnet_tpu_torch import convert
    plan = {}
    for name, p in model.named_parameters():
        if p.dim() < 2:
            continue
        d = convert.flax_last_dim(model, name)
        if p.shape[d] >= TP_MIN_DIM and p.shape[d] % parts == 0:
            plan[name] = d
    return plan


def _dense(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` dense in ``like``'s memory format (``channels_last`` maps stay
    so: the convolutions after them then run as in the unsplit model)."""
    cl = (like.dim() == 4 and not like.is_contiguous()
          and like.is_contiguous(memory_format=torch.channels_last))
    return t.contiguous(memory_format=torch.channels_last if cl
                        else torch.contiguous_format)


def _gather_cat(x: torch.Tensor, dim: int, group, parts: int
                ) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in rank order, in
    ``x``'s memory format."""
    x = _dense(x, x)
    outs = [torch.empty_like(x) for _ in range(parts)]
    dist.all_gather(outs, x, group=group)
    return torch.cat(outs, dim)


class _Gather(torch.autograd.Function):
    """All-gather over the model group along ``dim``; the backward keeps
    this rank's slice of the gradient, which every model peer holds
    whole (no collective)."""

    @staticmethod
    def forward(ctx, x, dim, group, parts, index):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return _gather_cat(x, dim, group, parts)

    @staticmethod
    def backward(ctx, g):
        return (_dense(g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), g),
                None, None, None, None)


class _ToModel(torch.autograd.Function):
    """The identity, whose backward all-reduces the gradient over the
    model group: each model rank's slice of output channels sends back
    its part of the input's (or the replicated bias's) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = _dense(g, g).clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Shards(nn.Module):
    """The parametrization of a split leaf: the stored ``original`` is this
    model rank's slice of ``dim``; reading the leaf all-gathers the slices
    over the model group (``right_inverse`` takes the slice of a whole
    tensor)."""

    def __init__(self, layout: Layout, dim: int):
        super().__init__()
        self.dim, self.group = dim, layout.model_group
        self.parts, self.index = layout.model, layout.model_index

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(shard, self.dim, self.group, self.parts,
                             self.index)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        n = full.shape[self.dim] // self.parts
        return full.narrow(self.dim, self.index * n, n).clone()


def _column_forward(self, x: torch.Tensor) -> torch.Tensor:
    """A Linear, Conv2d, ConvTranspose2d or StridedUpConv whose weight is
    split on its output channels: this rank's channels from the whole
    input with its slice of the replicated bias, all-gathered over the
    model group.  The bias enters through ``_ToModel``, so its gradient
    (each rank's slice) is summed whole on every model peer; at a model
    axis of 1 the module computes as the unsplit one, bit for bit."""
    from pdfnet_tpu_torch.models.layers import StridedUpConv
    tp = self.parametrizations.weight
    w, shards = tp.original, tp[0]
    group, parts, index = shards.group, shards.parts, shards.index
    x = _ToModel.apply(x, group)
    b = self.bias
    if b is not None:
        n = b.shape[0] // parts
        b = _ToModel.apply(b, group).narrow(0, index * n, n)
    if isinstance(self, StridedUpConv):
        y = self.project(x, w)
        y = y if b is None else y + b.to(y.dtype)
        return _Gather.apply(y, 3, group, parts, index).permute(0, 3, 1, 2)
    if isinstance(self, nn.Linear):
        y = F.linear(x, w, b)
        return _Gather.apply(y, y.dim() - 1, group, parts, index)
    if isinstance(self, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, b, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
    else:
        y = self._conv_forward(x, w, b)
    return _Gather.apply(y, 1, group, parts, index)


def _column_parallel(module: nn.Module, leaf: str, dim: int) -> bool:
    from pdfnet_tpu_torch.models.layers import StridedUpConv
    if leaf != "weight":
        return False
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        return dim == 0 and getattr(module, "groups", 1) == 1
    if isinstance(module, (nn.ConvTranspose2d, StridedUpConv)):
        return dim == 1 and getattr(module, "groups", 1) == 1
    return False


@dataclasses.dataclass
class _TensorParallel:
    layout: Layout
    names: List[str]          # named_parameters() before the split


def plain_name(name: str) -> str:
    """A parameter's name as the unsplit model has it
    (``x.parametrizations.weight.original`` is ``x.weight``)."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[-3] == "parametrizations" \
            and parts[-1] == "original":
        parts = parts[:-3] + [parts[-2]]
    return ".".join(parts)


def shard_params_tp(model: nn.Module, layout: Layout) -> Dict[str, int]:
    """Split the model's large parameters over the model axis of
    ``layout`` (JAX ``shard_params_tp``), after every rank has taken world
    rank 0's parameters and BatchNorm statistics (one full tree, as JAX
    places one): for each leaf of ``tp_plan(model, layout.model)`` model
    rank m keeps ``[m n/M, (m+1) n/M)`` of the planned dim as the stored
    parameter (its Adam moments then have the slice's shape), registered
    as a ``_Shards`` parametrization; a split Linear, Conv2d,
    ConvTranspose2d or StridedUpConv weight computes column-parallel
    (``_column_forward``).  Load the weights first.  Returns the plan
    (name -> dim).  COLLECTIVE: every rank calls it."""
    plan = tp_plan(model, layout.model)
    names = [n for n, _ in model.named_parameters()]
    if is_distributed():
        broadcast_tensors(list(model.parameters()) + stat_buffers(model))
    for name, d in plan.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        parametrize.register_parametrization(module, leaf,
                                             _Shards(layout, d), unsafe=True)
        if _column_parallel(module, leaf, d):
            module.forward = types.MethodType(_column_forward, module)
    model._tensor_parallel = _TensorParallel(layout, names)
    return plan


def _split(model: nn.Module) -> Optional[_TensorParallel]:
    return getattr(model, "_tensor_parallel", None)


def shard_tensors(model: nn.Module) -> List[torch.Tensor]:
    """The stored slices of the parameters ``shard_params_tp`` split, in
    parameter order (none for an unsplit model)."""
    if _split(model) is None:
        return []
    return [p for n, p in model.named_parameters() if n != plain_name(n)]


def unshard(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor shaped as this rank's slice of the parameter
    ``name`` (its gradient, a moment), all-gathered over the model group
    along the planned dim; ``t`` itself for a replicated one.  COLLECTIVE
    over the model group for a split one."""
    owner, _, leaf = plain_name(name).rpartition(".")
    module = model.get_submodule(owner)
    if not parametrize.is_parametrized(module, leaf):
        return t
    shards = module.parametrizations[leaf][0]
    return _gather_cat(t.detach(), shards.dim, shards.group, shards.parts)


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


def stat_buffers(model: nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm's running statistics."""
    return [b for n, b in model.named_buffers() if n.endswith(STAT_BUFFERS)]


def _unsplit_opt_state(model: nn.Module, sd: dict) -> dict:
    """The optimizer ``state_dict`` of a split model (its parameters in
    the split model's order, split moments) in the unsplit model's order
    with whole moments.  COLLECTIVE over the model group."""
    tp = _split(model)
    order = {n: i for i, n in enumerate(tp.names)}
    names = [plain_name(n) for n, _ in model.named_parameters()]
    state = {}
    for i, s in sd["state"].items():
        s = dict(s)
        for k in ("exp_avg", "exp_avg_sq"):
            if k in s:
                s[k] = unshard(model, names[int(i)], s[k])
        state[order[names[int(i)]]] = s
    return {"state": dict(sorted(state.items())),
            "param_groups": sd["param_groups"]}


def gather_to_host(state) -> dict:
    """A host copy of a train state (``model``, ``optimizer``, ``step``)
    in the one-process checkpoint format: ``params``, ``batch_stats``
    (every BatchNorm's running statistics), ``opt_state`` (the replicated
    Adam's ``state_dict``) and ``step``.  A model split by
    ``shard_params_tp`` has its slices all-gathered over the model group:
    every rank returns the whole tree, under the unsplit names and order.
    COLLECTIVE when the optimizer state is split (``Zero1Adam``) or the
    model is: every rank must call it."""
    model = state.model
    tp = _split(model)
    sd = state.optimizer.state_dict()
    if tp is None:
        params = {n: _to_cpu(p) for n, p in model.named_parameters()}
    else:
        split = {plain_name(n): unshard(model, n, p)
                 for n, p in model.named_parameters()}
        params = {n: _to_cpu(split[n]) for n in tp.names}
        sd = _unsplit_opt_state(model, sd)
    return {"params": params,
            "batch_stats": {n: _to_cpu(b) for n, b in model.named_buffers()
                            if n.endswith(STAT_BUFFERS)},
            "opt_state": _to_cpu(sd),
            "step": int(state.step)}
