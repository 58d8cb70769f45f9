"""JAX (flax) variables -> the port's ``state_dict``.

``from_flax`` takes the JAX model's ``{"params", "batch_stats"}`` tree as
numpy arrays and returns a ``state_dict`` for the port's module.  Port module
paths follow the flax module paths (``encoder/resnet/layer1_0/conv1`` is
``encoder.resnet.layer1_0.conv1``), and each leaf's layout transform is
chosen by the type of the port module at that path, with the rules of
``pdfnet_tpu/utils/convert_torch.py:27-40`` run backwards:

  Conv2d                       HWIO -> OIHW
  ConvTranspose2d, StridedUpConv  (kh, kw, I, O) -> spatial flip, (I, O, kh, kw)
  Linear                       (I, O) -> (O, I)
  BatchNorm                    scale/bias/mean/var -> weight/bias/running_*
  LayerNorm                    scale/bias -> weight/bias
  Embedding                    embedding -> weight
  L2Norm                       weight -> weight
  any other module             a bare ``self.param`` leaf (``ImgAttn``'s
                               ``pos_emb``) -> the ``nn.Parameter`` of the
                               same name, unchanged

Every flax leaf and every port parameter or running statistic must be used
exactly once, or the call raises.  ``params_from_flax`` applies the same
mapping to any tree shaped like the ``params`` collection (gradients, Adam
moments), so such trees compare leaf by leaf with the port's.  ``flax_last_dim``
names the port dim that holds a flax leaf's last axis (the axis JAX's
tensor-parallel placement splits).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from pdfnet_tpu_torch.models.layers import L2Norm, StridedUpConv


def _conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _conv_t(w):
    return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))


def _linear(w):
    return np.transpose(w)


def _same(w):
    return w


# the port dim that holds a flax leaf's last axis, by transform (``_same``:
# the last dim)
_LAST_DIM = {_conv: 0, _conv_t: 1, _linear: 0}


_BN_LEAVES = {("params", "scale"): ("weight", _same),
              ("params", "bias"): ("bias", _same),
              ("batch_stats", "mean"): ("running_mean", _same),
              ("batch_stats", "var"): ("running_var", _same)}

# port module type -> {(collection, flax leaf): (port leaf, transform)}
_RULES: Tuple[Tuple[type, Dict[Tuple[str, str], Tuple[str, Callable]]], ...] = (
    (nn.Conv2d, {("params", "kernel"): ("weight", _conv),
                 ("params", "bias"): ("bias", _same)}),
    (nn.ConvTranspose2d, {("params", "kernel"): ("weight", _conv_t),
                          ("params", "bias"): ("bias", _same)}),
    (StridedUpConv, {("params", "kernel"): ("weight", _conv_t),
                     ("params", "bias"): ("bias", _same)}),
    (nn.Linear, {("params", "kernel"): ("weight", _linear),
                 ("params", "bias"): ("bias", _same)}),
    (nn.modules.batchnorm._BatchNorm, _BN_LEAVES),
    (nn.LayerNorm, {("params", "scale"): ("weight", _same),
                    ("params", "bias"): ("bias", _same)}),
    (nn.Embedding, {("params", "embedding"): ("weight", _same)}),
    (L2Norm, {("params", "weight"): ("weight", _same)}),
)


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _leaf_rule(module: nn.Module, collection: str, leaf: str):
    """(port leaf, transform) for the flax leaf ``collection/leaf`` of the
    port module ``module``, or None."""
    for cls, rule in _RULES:
        if isinstance(module, cls):
            return rule.get((collection, leaf))
    if collection == "params" and leaf in module._parameters:
        return leaf, _same
    return None


def flax_last_dim(model: nn.Module, name: str) -> int:
    """The dim of the port parameter ``name`` that holds the last axis of
    the flax leaf it stands for: the output channels of a Conv2d or Linear
    kernel (dim 0), of a transposed one (dim 1), the last dim of any other
    leaf (an ``Embedding``'s features, a bare parameter)."""
    owner, _, leaf = name.rpartition(".")
    module = model.get_submodule(owner)
    last = model.get_parameter(name).dim() - 1
    for cls, rule in _RULES:
        if isinstance(module, cls):
            for (collection, _), (port_leaf, tf) in rule.items():
                if collection == "params" and port_leaf == leaf:
                    return _LAST_DIM.get(tf, last)
    return last


def _convert(variables, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every leaf of ``variables`` ({"params": ..., "batch_stats": ...},
    either may be missing) under the port's name, in its layout."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for (collection, *mod_path, leaf), value in _leaves(
            {c: variables[c] for c in ("params", "batch_stats")
             if c in variables}):
        name = ".".join(mod_path)
        try:
            module = model.get_submodule(name)
        except AttributeError as e:
            raise ValueError(f"convert: flax module {name!r} has no "
                             "counterpart in the port") from e
        rule = _leaf_rule(module, collection, leaf)
        if rule is None:
            raise ValueError(f"convert: unexpected leaf {collection}/{name}/"
                             f"{leaf} for {type(module).__name__}")
        port_leaf, tf = rule
        key = f"{name}.{port_leaf}" if name else port_leaf
        if key in out:
            raise ValueError(f"convert: {key} set twice")
        ref = target[key]
        arr = np.ascontiguousarray(tf(value.astype(np.float32)))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"convert: {key} has shape {tuple(ref.shape)}, "
                             f"flax {collection}/{name}/{leaf} gives "
                             f"{tuple(arr.shape)}")
        out[key] = torch.from_numpy(arr).to(ref.dtype)
    return out


def _require(out: Dict[str, torch.Tensor], keys, what: str) -> None:
    missing = [k for k in keys if k not in out]
    if missing:
        raise ValueError(f"convert: {len(missing)} port {what} not set by "
                         f"the flax tree, e.g. {missing[:5]}")


def from_flax(variables, model: nn.Module,
              keep: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``model`` from flax ``variables``.
    Entries whose name contains one of ``keep`` may be absent from the
    tree; they keep the model's values."""
    out = _convert(variables, model)
    target = model.state_dict()
    # the step counters of BatchNorm have no flax counterpart
    _require(out, [k for k in target if not k.endswith("num_batches_tracked")
                   and not any(s in k for s in keep)], "entries")
    for k, v in target.items():
        out.setdefault(k, v.clone())
    return out


def params_from_flax(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Any tree shaped like the flax ``params`` collection (parameters,
    gradients, optimizer moments) -> {port parameter name: tensor} in the
    port's layouts, one entry per ``model.named_parameters()``."""
    out = _convert({"params": params}, model)
    _require(out, [k for k, _ in model.named_parameters()], "parameters")
    return out
