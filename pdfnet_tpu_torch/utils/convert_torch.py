"""Reference PyTorch checkpoints (``.pth`` of HandNET_GCN,
intaghand_model.py) into the port's ``HandNet`` (port of
``pdfnet_tpu/utils/convert_torch.py``, whose name mapping this module
keeps a copy of: the port imports nothing of the JAX package).

The mapping names every live parameter of the reference model by its path
in the flax variables tree, with the layout transforms flax expects:

  Conv2d    (O, I, kh, kw) -> (kh, kw, I, O)
  ConvT2d   (I, O, kh, kw) -> spatial-flip then (kh, kw, I, O)
  Linear    (O, I)         -> (I, O)
  BatchNorm weight/bias/running_* -> scale/bias + batch_stats mean/var
  1x1-conv-as-Dense (O, I, 1, 1) -> (I, O)

and ``pdfnet_tpu_torch.convert.from_flax`` carries that tree into the
port's ``state_dict`` (``load_reference_checkpoint`` chains the two).  Dead
reference parameters (mano_head, joint_head_l/r, netR_FC, resnet.fc, GCN
norm1, img_ex) are skipped and reported, as are the BatchNorm step
counters.  The mapping names no ``img_ex`` entry whatever ``use_img_attn``
says (the JAX ``build_mapping(use_img_attn)`` does not read its argument:
the reference constructs img_ex but its forward never calls it), so a model
with ``use_img_attn`` keeps its own ``ImgAttn`` weights when it loads a
reference checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from pdfnet_tpu_torch import convert


def _conv(w):
    return np.transpose(w, (2, 3, 1, 0))


def _convT(w):
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))


def _lin(w):
    return np.transpose(w)


def _dense1x1(w):
    return np.transpose(w[:, :, 0, 0])


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _bn(mapping, src, params_path, stats_path):
    mapping[f"{src}.weight"] = (("params",) + params_path + ("scale",), None)
    mapping[f"{src}.bias"] = (("params",) + params_path + ("bias",), None)
    mapping[f"{src}.running_mean"] = (
        ("batch_stats",) + stats_path + ("mean",), None)
    mapping[f"{src}.running_var"] = (
        ("batch_stats",) + stats_path + ("var",), None)


def _ln(mapping, src, path):
    mapping[f"{src}.weight"] = (("params",) + path + ("scale",), None)
    mapping[f"{src}.bias"] = (("params",) + path + ("bias",), None)


def _dense(mapping, src, path, bias=True):
    mapping[f"{src}.weight"] = (("params",) + path + ("kernel",), _lin)
    if bias:
        mapping[f"{src}.bias"] = (("params",) + path + ("bias",), None)


def _conv2d(mapping, src, path, bias=True):
    mapping[f"{src}.weight"] = (("params",) + path + ("kernel",), _conv)
    if bias:
        mapping[f"{src}.bias"] = (("params",) + path + ("bias",), None)


def _sft(mapping, src, path):
    for t_name, f_name in (("SFT_scale_conv0", "scale0"),
                           ("SFT_scale_conv1", "scale1"),
                           ("SFT_shift_conv0", "shift0"),
                           ("SFT_shift_conv1", "shift1")):
        mapping[f"{src}.{t_name}.weight"] = (
            ("params",) + path + (f_name, "kernel"), _dense1x1)
        mapping[f"{src}.{t_name}.bias"] = (
            ("params",) + path + (f_name, "bias"), None)


def _self_attn(mapping, src, path):
    for t, f in (("w_qs", "wq"), ("w_ks", "wk"), ("w_vs", "wv"), ("fc", "fc")):
        _dense(mapping, f"{src}.{t}", path + (f,))
    _ln(mapping, f"{src}.layer_norm", path + ("ln",))
    _ln(mapping, f"{src}.ff.layer_norm", path + ("ff", "ln"))
    _dense(mapping, f"{src}.ff.fc1", path + ("ff", "fc1"))
    _dense(mapping, f"{src}.ff.fc2", path + ("ff", "fc2"))


def build_mapping() -> Dict[str, Tuple]:
    m: Dict[str, Tuple] = {}
    enc = ("encoder",)

    # --- resnet trunk ------------------------------------------------------
    _conv2d(m, "encoder.resnet.conv1", enc + ("resnet", "conv1"), bias=False)
    _bn(m, "encoder.resnet.bn1", enc + ("resnet", "bn1"),
        enc + ("resnet", "bn1"))
    blocks = {1: 3, 2: 4, 3: 6, 4: 3}
    for li, n in blocks.items():
        for b in range(n):
            src = f"encoder.resnet.layer{li}.{b}"
            dst = enc + ("resnet", f"layer{li}_{b}")
            for ci in (1, 2, 3):
                _conv2d(m, f"{src}.conv{ci}", dst + (f"conv{ci}",), bias=False)
                _bn(m, f"{src}.bn{ci}", dst + (f"bn{ci}",), dst + (f"bn{ci}",))
            if b == 0:
                _conv2d(m, f"{src}.downsample.0", dst + ("proj_conv",),
                        bias=False)
                _bn(m, f"{src}.downsample.1", dst + ("proj_bn",),
                    dst + ("proj_bn",))

    # --- FPN ---------------------------------------------------------------
    _conv2d(m, "encoder.p2", enc + ("p2",))
    for p in ("p3", "p4", "p5"):
        m[f"encoder.{p}.weight"] = (("params",) + enc + (p, "kernel"), _convT)
        m[f"encoder.{p}.bias"] = (("params",) + enc + (p, "bias"), None)
    for p in ("p2", "p3", "p4", "p5"):
        m[f"encoder.{p}_l2.weight"] = (
            ("params",) + enc + (f"{p}_l2", "weight"), None)
    _conv2d(m, "encoder.feat", enc + ("feat",), bias=False)
    _bn(m, "encoder.feat_bn", enc + ("feat_bn",), enc + ("feat_bn",))
    _conv2d(m, "encoder.e_conv1", enc + ("e_conv1",), bias=False)

    # --- heads -------------------------------------------------------------
    for head in ("hm", "wh", "params"):
        _conv2d(m, f"encoder.{head}.0", enc + (f"head_{head}", "conv0"))
        _conv2d(m, f"encoder.{head}.2", enc + (f"head_{head}", "conv1"))

    # --- hms / dp decoders -------------------------------------------------
    for name in ("hms_decoder", "dp_decoder"):
        base = enc + (name,)
        _conv2d(m, f"encoder.{name}.models.0.0", base + ("stage0",), bias=False)
        _bn(m, f"encoder.{name}.models.0.2", base + ("bn0",), base + ("bn0",))
        for i in (1, 2, 3):
            _conv2d(m, f"encoder.{name}.models.{i}.1", base + (f"stage{i}",),
                    bias=False)
            _bn(m, f"encoder.{name}.models.{i}.3", base + (f"bn{i}",),
                base + (f"bn{i}",))
    _conv2d(m, "encoder.hms_decoder.final_layer.0",
            enc + ("hms_decoder", "head"))
    _conv2d(m, "encoder.dp_decoder.final_layer.1",
            enc + ("dp_decoder", "head"))

    # --- center features + fused SFT --------------------------------------
    _conv2d(m, "encoder.center_feat_up0", enc + ("center_up0",), bias=False)
    _conv2d(m, "encoder.center_feat_up1", enc + ("center_up1",), bias=False)
    _sft(m, "encoder.sft", enc + ("sft",))

    # --- pointnet ----------------------------------------------------------
    pn = enc + ("pointnet",)
    for i in range(3):
        _sft(m, f"encoder.pointnet_plus.sft{i}", pn + (f"sft{i}",))
    for net, mlp in (("netR_1", "mlp1"), ("netR_2", "mlp2"), ("netR_3", "mlp3")):
        for j, (c_idx, b_idx) in enumerate(((0, 1), (3, 4), (6, 7))):
            m[f"encoder.pointnet_plus.{net}.{c_idx}.weight"] = (
                ("params",) + pn + (mlp, f"fc{j}", "kernel"), _dense1x1)
            m[f"encoder.pointnet_plus.{net}.{c_idx}.bias"] = (
                ("params",) + pn + (mlp, f"fc{j}", "bias"), None)
            _bn(m, f"encoder.pointnet_plus.{net}.{b_idx}",
                pn + (mlp, f"bn{j}"), pn + (mlp, f"bn{j}"))

    # --- mid fusion --------------------------------------------------------
    for i in range(4):
        _conv2d(m, f"mid_model.convs.{i}.0", ("mid", f"conv{i}", "conv"),
                bias=False)
        _bn(m, f"mid_model.convs.{i}.2", ("mid", f"conv{i}", "bn"),
            ("mid", f"conv{i}", "bn"))

    # --- GCN decoder -------------------------------------------------------
    dec = ("decoder",)
    _dense(m, "decoder.gf_layer_left.0", dec + ("gf_left",))
    _ln(m, "decoder.gf_layer_left.1", dec + ("gf_left_ln",))
    _dense(m, "decoder.gf_layer_right.0", dec + ("gf_right",))
    _ln(m, "decoder.gf_layer_right.1", dec + ("gf_right_ln",))
    m["decoder.unsample_layer.weight"] = (
        ("params",) + dec + ("unsample", "kernel"), _lin)
    for head in ("coord_head", "avg_head", "params_head", "root_head"):
        _dense(m, f"decoder.{head}", dec + (head,))

    for i in range(3):
        lsrc = f"decoder.dual_gcn.layers.{i}"
        ldst = dec + (f"level{i}",)
        m[f"{lsrc}.position_embeddings.weight"] = (
            ("params",) + ldst + ("pos_emb", "embedding"), None)
        for side in ("left", "right"):
            for b in range(4):
                bsrc = f"{lsrc}.graph_{side}.GCN_blocks.{b}"
                bdst = ldst + (f"graph_{side}", f"block{b}")
                _dense(m, f"{bsrc}.fc1", bdst + ("fc1",))
                _dense(m, f"{bsrc}.fc2", bdst + ("fc2",))
                _dense(m, f"{bsrc}.shortcut", bdst + ("shortcut",))
                _ln(m, f"{bsrc}.norm2", bdst + ("norm2",))
                _ln(m, f"{bsrc}.norm3", bdst + ("norm3",))
                # norm1 is dead in the reference forward: skipped.
        attn = ldst + ("inter_attn",)
        _self_attn(m, f"{lsrc}.attn.L_self_attn_layer", attn + ("self_L",))
        _self_attn(m, f"{lsrc}.attn.R_self_attn_layer", attn + ("self_R",))
        for t, f in (("w_qs", "wq"), ("w_ks", "wk"), ("w_vs", "wv"),
                     ("fc", "fc")):
            _dense(m, f"{lsrc}.attn.{t}", attn + (f,))
        _ln(m, f"{lsrc}.attn.layer_norm1", attn + ("ln_L",))
        _ln(m, f"{lsrc}.attn.layer_norm2", attn + ("ln_R",))
        for ff in ("ffL", "ffR"):
            _ln(m, f"{lsrc}.attn.{ff}.layer_norm", attn + (ff, "ln"))
            _dense(m, f"{lsrc}.attn.{ff}.fc1", attn + (ff, "fc1"))
            _dense(m, f"{lsrc}.attn.{ff}.fc2", attn + (ff, "fc2"))
    return m


def convert_state_dict(state: Dict[str, np.ndarray], verbose: bool = True):
    """torch name->array dict -> ({'params': ..., 'batch_stats': ...},
    skipped names).  The JAX function's ``use_img_attn`` argument changes
    nothing there (no img_ex entry is mapped either way) and is not taken
    here."""
    # strip DataParallel prefixes (reference load_model semantics)
    state = {(k[7:] if k.startswith("module.") else k): v
             for k, v in state.items()}
    mapping = build_mapping()
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    used = set()
    for src, (path, tf) in mapping.items():
        if src not in state:
            if verbose:
                print(f"convert: MISSING in checkpoint: {src}")
            continue
        v = np.asarray(state[src], np.float32)
        if tf is not None:
            v = tf(v)
        _set(out[path[0]], path[1:], v)
        used.add(src)
    skipped = [k for k in state if k not in used
               and "num_batches_tracked" not in k]
    if verbose and skipped:
        print(f"convert: skipped {len(skipped)} dead/unmapped entries "
              f"(e.g. {skipped[:5]})")
    return out, skipped


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a reference .pth and return the raw name->ndarray dict (its
    ``state_dict`` entry, or the file itself when it is one).  Tensors and
    plain containers only: nothing else is unpickled."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def load_reference_checkpoint(path: str, model: torch.nn.Module,
                              verbose: bool = True) -> List[str]:
    """Load a reference ``.pth`` into the port's ``HandNet`` in place:
    ``convert_state_dict``, then ``convert.from_flax``, then
    ``load_state_dict``.  Every parameter and running statistic of the port
    must be set by the checkpoint, or ``from_flax`` raises naming what is
    missing; under ``use_img_attn`` the decoder's ``ImgAttn`` modules
    (``img_ex_left`` / ``img_ex_right``), which no reference entry maps,
    keep the model's weights.  Returns the skipped (dead) reference
    names."""
    img_attn = model.cfg.use_img_attn
    variables, skipped = convert_state_dict(load_torch_checkpoint(path),
                                            verbose=verbose)
    keep = (".img_ex_",) if img_attn else ()
    if img_attn and verbose:
        print("convert: use_img_attn: the decoder's img_ex_* weights keep "
              "the model's values (the reference's are not mapped)")
    model.load_state_dict(convert.from_flax(variables, model, keep))
    return skipped
