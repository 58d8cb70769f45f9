"""Checkpoint save / restore in torch's format, with tolerant partial
restore (port of ``pdfnet_tpu/train/checkpoint.py``, which uses orbax).

Mirrors the reference semantics (lib/utils/utils.py:37-119): a checkpoint
``{ckpt_dir}/model_{epoch}`` is one ``torch.save`` file carrying

- ``params``: every parameter by its module path,
- ``batch_stats``: every BatchNorm's ``running_mean`` / ``running_var``,
- ``opt_state``: the Adam state (``torch.optim.Adam.state_dict``: each
  parameter's moments and step count),
- ``step``: the number of train steps taken, and ``epoch``.

Restore overlays the entries whose name and shape match and keeps the rest
as initialised, with a line for each skipped entry, instead of failing; the
optimizer state is restored when it matches the parameters, else kept.
Tensors are saved from and restored to their exact bits.  The format does
not depend on the number of processes: under ``zero1_opt_sharding`` the
split Adam moments are gathered into it (``parallel.mesh.gather_to_host``)
and each rank takes its slice back on restore.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from pdfnet_tpu_torch.parallel.mesh import STAT_BUFFERS as _STATS
from pdfnet_tpu_torch.parallel.mesh import gather_to_host
from pdfnet_tpu_torch.train.step import TrainState


def _params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def _epochs(ckpt_dir: str, prefix: str = "model_"):
    """(epoch, name) of the checkpoints ``{prefix}{epoch}`` in ckpt_dir."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((int(d[len(prefix):]), d) for d in os.listdir(ckpt_dir)
                  if d.startswith(prefix) and d[len(prefix):].isdigit())


def _write(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: TrainState | dict, epoch: int,
                    keep: int = 10) -> str:
    """Write ``state`` (a train state, or its ``gather_to_host`` copy) as
    ``{ckpt_dir}/model_{epoch}``; returns the path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_{epoch}")
    host = state if isinstance(state, dict) else gather_to_host(state)
    _write(path, {**host, "epoch": int(epoch)})
    # retention: keep the ``keep`` newest model_<epoch> checkpoints
    if keep and keep > 0:
        for _, old in _epochs(ckpt_dir)[:-keep]:
            os.remove(os.path.join(ckpt_dir, old))
    return path


def _load(path: str) -> dict:
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def _tolerant_merge(targets: Dict[str, torch.Tensor],
                    loaded: Dict[str, torch.Tensor]) -> None:
    """Copy loaded entries into the targets (tensors of the model) where the
    names and shapes match; report the rest, which keep their values."""
    with torch.no_grad():
        for key, val in targets.items():
            if key not in loaded:
                print(f"checkpoint: missing {key}, keeping init")
            elif tuple(loaded[key].shape) != tuple(val.shape):
                print(f"checkpoint: skip {key}: shape "
                      f"{tuple(loaded[key].shape)} != {tuple(val.shape)}")
            else:
                val.copy_(loaded[key])


def _restore_variables(model: torch.nn.Module, loaded: dict) -> None:
    _tolerant_merge(dict(model.named_parameters()),
                    loaded.get("params", {}))
    _tolerant_merge({n: b for n, b in model.named_buffers()
                     if n.endswith(_STATS)}, loaded.get("batch_stats", {}))


def _optimizer_matches(state: TrainState, saved: dict) -> bool:
    """The saved Adam state has the optimizer's groups and, for every
    parameter it holds moments of, moments of that parameter's shape."""
    params = list(state.model.parameters())
    groups = saved.get("param_groups", [])
    if [len(g["params"]) for g in groups] != [
            len(g["params"]) for g in state.optimizer.param_groups]:
        return False
    for i, st in saved.get("state", {}).items():
        if not 0 <= int(i) < len(params):
            return False
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st and tuple(st[k].shape) != tuple(params[int(i)].shape):
                return False
    return True


def load_checkpoint(path: str, state: TrainState,
                    resume_optimizer: bool = True) -> Tuple[TrainState, int]:
    """Restore into an existing state, in place; returns (state,
    start_epoch) as the JAX function does (the epoch the checkpoint was
    saved after).  Every rank of a process group reads the file; no
    collective."""
    loaded = _load(path)
    _restore_variables(state.model, loaded)
    if resume_optimizer and "opt_state" in loaded:
        if _optimizer_matches(state, loaded["opt_state"]):
            state.optimizer.load_state_dict(loaded["opt_state"])
            state.step = int(loaded.get("step", state.step))
        else:
            print("checkpoint: optimizer state incompatible, reinitialized")
    return state, int(loaded.get("epoch", 0))


def load_variables(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Tolerant parameter and BatchNorm-statistics restore for inference:
    the same merge as ``load_checkpoint``, no optimizer state (a trainer
    checkpoint's extra entries are ignored)."""
    _restore_variables(model, _load(path))
    return model


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    found = _epochs(ckpt_dir)
    return os.path.join(ckpt_dir, found[-1][1]) if found else None


def save_subtree_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                            subtree: str = "decoder") -> str:
    """Save only one top-level module's parameters (reference
    main.py:127-129 saves a GCN-decoder-only checkpoint with buffers
    stripped)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    params = _params(state.model)
    tops = sorted({n.split(".")[0] for n in params})
    if subtree not in tops:
        raise KeyError(f"no top-level module {subtree!r}; have {tops}")
    path = os.path.join(ckpt_dir, f"{subtree}_{epoch}")
    _write(path, {"params": {n: v for n, v in params.items()
                             if n.split(".")[0] == subtree},
                  "epoch": int(epoch)})
    return path
