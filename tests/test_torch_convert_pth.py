"""Reference ``.pth`` checkpoints into the port
(``pdfnet_tpu_torch.utils.convert_torch``) against the JAX package's
converter (``pdfnet_tpu.utils.convert_torch``).

The checkpoint is built from a JAX variables tree (seeded numpy values for
every leaf, ``test_torch_eval_step.jax_variables``) by running each of the
mapping's layout transforms backwards, so every reference name carries a
known value; it is saved as the reference trainer does,
``{"state_dict": {"module." + name: tensor}, ...}``, with the BatchNorm
step counters and a few dead heads beside the live entries.  Both packages'
converters must give identical trees and the same skipped names, and the
port's ``HandNet`` loaded from the file must match the JAX model on the
same batch within 2e-4 (float32, the small config of
``test_torch_eval_step.py``, whose tolerance argument holds here too).
"""

import jax
import numpy as np
import pytest
import torch

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import build_model as jax_build_model
from pdfnet_tpu.ops import grouping
from pdfnet_tpu.train.loss import load_loss_consts as jax_consts
from pdfnet_tpu.train.step import make_eval_step as jax_eval_step
from pdfnet_tpu.utils import convert_torch as jax_ct

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.utils import convert_torch as port_ct

from test_torch_eval_step import SMALL, TOL, _batch, jax_variables

# the mapping's transforms run backwards: flax layout -> reference layout
INVERSE = {
    None: lambda w: w,
    jax_ct._conv: lambda w: np.transpose(w, (3, 2, 0, 1)),
    jax_ct._convT: lambda w: np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1],
    jax_ct._lin: np.transpose,
    jax_ct._dense1x1: lambda w: np.transpose(w)[:, :, None, None],
}
DEAD = ("mano_head.weight", "encoder.resnet.fc.weight",
        "decoder.dual_gcn.layers.0.graph_left.GCN_blocks.0.norm1.weight")


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _paths(tree, path=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def reference_state(variables):
    """Reference name -> array for every entry of the mapping."""
    return {src: np.ascontiguousarray(INVERSE[tf](_leaf(variables, path)))
            for src, (path, tf) in jax_ct.build_mapping().items()}


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    cfg = JaxConfig(**SMALL)
    batch = _batch(2, cfg.default_resolution, cfg.sample_num)
    variables = jax_variables(cfg, batch)
    state = {"module." + k: torch.from_numpy(v.copy())
             for k, v in reference_state(variables).items()}
    state["module.encoder.resnet.bn1.num_batches_tracked"] = torch.tensor(7)
    rng = np.random.RandomState(2)
    for name in DEAD:
        state["module." + name] = torch.from_numpy(rng.randn(4, 4).astype(
            np.float32))
    path = str(tmp_path_factory.mktemp("ref") / "model_best.pth")
    torch.save({"epoch": 3, "state_dict": state}, path)
    return dict(path=path, variables=variables, batch=batch, state=state)


def test_mapping_covers_the_jax_tree(pth):
    """Every leaf of the flax tree is named by one reference entry."""
    mapped = {path for path, _ in jax_ct.build_mapping().values()}
    leaves = set(_paths({c: pth["variables"][c]
                         for c in ("params", "batch_stats")}))
    assert leaves == mapped


def test_mapping_is_the_jax_packages():
    mp, mj = port_ct.build_mapping(), jax_ct.build_mapping()
    assert list(mp) == list(mj)
    assert all(mp[k][0] == mj[k][0] for k in mp)
    assert ([None if mp[k][1] is None else mp[k][1].__name__ for k in mp]
            == [None if mj[k][1] is None else mj[k][1].__name__ for k in mj])


def test_load_torch_checkpoint_matches(pth):
    got = port_ct.load_torch_checkpoint(pth["path"])
    ref = jax_ct.load_torch_checkpoint(pth["path"])
    assert list(got) == list(ref) and len(got) == len(pth["state"])
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_converted_trees_identical(pth):
    """The ``module.`` prefix stripped, the step counters and dead heads
    skipped, every leaf equal bit for bit and equal to the tree the file
    was made from."""
    state = port_ct.load_torch_checkpoint(pth["path"])
    tp, sp = port_ct.convert_state_dict(state, verbose=False)
    tj, sj = jax_ct.convert_state_dict(state, verbose=False)
    assert sp == sj == list(DEAD)
    paths = sorted(_paths(tj))
    assert sorted(_paths(tp)) == paths and len(paths) > 500
    for path in paths:
        a, b = _leaf(tp, path), _leaf(tj, path)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))
        np.testing.assert_array_equal(a, _leaf(pth["variables"], path))


def test_use_img_attn_loads_and_matches_jax(tmp_path):
    """A reference checkpoint with ``img_ex`` entries (constructed by the
    reference, never called in its forward) into a model with
    ``use_img_attn``: the mapping is the JAX package's
    ``build_mapping(use_img_attn=True)``, the ``img_ex`` entries are
    skipped as JAX skips them, the decoder's ``ImgAttn`` keeps the model's
    weights (here the JAX model's, set before the load), and the eval step
    then matches JAX's on the flax tree within TOL.  At res 192, where the
    image attention's grid has patches; ``topk`` grouping on both sides."""
    torch.set_num_threads(1)
    opts = dict(SMALL, default_resolution=192, knn_method="topk",
                gather_method="take", use_img_attn=True)
    cfg_j = JaxConfig(**opts)
    batch = _batch(1, 192, cfg_j.sample_num)
    variables = jax_variables(cfg_j, batch)
    mapping = jax_ct.build_mapping(use_img_attn=True)
    assert list(port_ct.build_mapping()) == list(mapping)
    state = {"module." + k: torch.from_numpy(v.copy())
             for k, v in reference_state(variables).items()}
    img_ex = {f"module.decoder.dual_gcn.layers.0.img_ex_left.{n}":
              torch.randn(4, 4) for n in ("pos_embedding", "proj.weight")}
    state.update(img_ex)
    path = str(tmp_path / "img_attn.pth")
    torch.save({"state_dict": state}, path)
    _, skipped_j = jax_ct.convert_state_dict(
        port_ct.load_torch_checkpoint(path), use_img_attn=True,
        verbose=False)
    assert sorted(skipped_j) == sorted(k[7:] for k in img_ex)

    cfg = port.Config(**opts)
    model = port.HandNet(cfg).eval()
    full = convert.from_flax(variables, model)
    model.load_state_dict({k: v for k, v in full.items()
                           if ".img_ex_" in k}, strict=False)
    skipped = port_ct.load_reference_checkpoint(path, model, verbose=False)
    assert skipped == skipped_j
    for k, v in model.state_dict().items():
        assert torch.equal(v, full[k]), k

    step = jax_eval_step(cfg_j, jax_build_model(cfg_j), jax_consts())
    ref = step(variables["params"], variables["batch_stats"],
               {k: jax.numpy.asarray(v) for k, v in batch.items()})
    got = port.make_eval_step(cfg, model, port.load_loss_consts("cpu"))(batch)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def test_missing_live_entry_is_named(pth, tmp_path):
    state = dict(pth["state"])
    del state["module.encoder.feat_bn.running_var"]
    path = str(tmp_path / "partial.pth")
    torch.save({"state_dict": state}, path)
    model = port.HandNet(port.Config(**SMALL))
    with pytest.raises(ValueError, match="encoder.feat_bn.running_var"):
        port_ct.load_reference_checkpoint(path, model, verbose=False)


def test_loaded_model_matches_jax(pth):
    """The port's HandNet loaded from the .pth against the JAX model on the
    flax tree the file was made from: every eval output within TOL."""
    torch.set_num_threads(1)
    batch = pth["batch"]
    cfg_j = JaxConfig(**SMALL)
    old = grouping._FUSED_INTERPRET
    grouping._FUSED_INTERPRET = True
    try:
        step = jax_eval_step(cfg_j, jax_build_model(cfg_j), jax_consts())
        ref = step(pth["variables"]["params"],
                   pth["variables"]["batch_stats"],
                   {k: jax.numpy.asarray(v) for k, v in batch.items()})
        ref = {k: np.asarray(v) for k, v in ref.items()}
    finally:
        grouping._FUSED_INTERPRET = old

    cfg = port.Config(**SMALL)
    model = port.HandNet(cfg).eval()
    skipped = port_ct.load_reference_checkpoint(pth["path"], model,
                                                verbose=False)
    assert len(skipped) == len(DEAD)
    got = port.make_eval_step(cfg, model, port.load_loss_consts("cpu"))(batch)
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.shape == ref[k].shape and torch.isfinite(v).all(), k
        np.testing.assert_allclose(v.numpy(), ref[k], **TOL, err_msg=k)
