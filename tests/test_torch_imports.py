"""Package hygiene of the PyTorch port: it imports nothing of JAX or of the
JAX package, its ``Config`` mirrors ``pdfnet_tpu.config.Config``, every
entry point refuses by name the device limits that remain (the selection
kernel's shared memory), and the values it has since taken (FPS, normals,
``knn_method="approx"``, ``use_img_attn``, ``s2d_stem``, ``patch_heads``,
``image_summary``, ``photometric_loss``, the CSP archs, the trainer's
``zero1_opt_sharding``, the CLI's multi-process flags) build a model and
run."""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import pdfnet_tpu_torch
from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu_torch import HandNet, build_model
from pdfnet_tpu_torch.config import Config as PortConfig
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pdfnet_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pdfnet_tpu_torch.__path__, "pdfnet_tpu_torch."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter, importing every module of the port loads no
    jax, flax, optax or pdfnet_tpu module."""
    mods = _modules()
    assert "pdfnet_tpu_torch.ops.sa" in mods and len(mods) >= 15
    assert "pdfnet_tpu_torch.parallel.mesh" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'pdfnet_tpu'))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_jax_or_jax_package():
    """No source of the port imports jax/flax/optax or a ``pdfnet_tpu``
    module (``pdfnet_tpu_torch`` itself excepted)."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|pdfnet_tpu)"
                     r"(\.|\s|$)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if bad.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def test_config_mirrors_jax_config():
    """Same field names, order, types and defaults; same derived values."""
    jf = dataclasses.fields(JaxConfig)
    pf = dataclasses.fields(PortConfig)
    assert [f.name for f in pf] == [f.name for f in jf]
    assert [str(f.type) for f in pf] == [str(f.type) for f in jf]
    j, p = JaxConfig(), PortConfig()
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for name in ("input_res", "size_train", "output_res", "heads"):
        assert getattr(p, name) == getattr(j, name), name
    q = p.replace(photometric_loss=True, off=True)
    assert q.heads == j.replace(photometric_loss=True, off=True).heads


def test_new_modules_are_walked():
    """The serving path's, the CLI paths' and the bench entry's modules are
    among those imported above."""
    mods = _modules()
    for m in ("ops.pointcloud", "ops.trunk", "ops.grouping", "native",
              "data.augment", "data.h2o", "data.loader", "data.prefetch",
              "data.synthetic", "train.metrics", "train.checkpoint",
              "train.trainer", "utils.vis", "utils.profiler", "cli.main",
              "utils.eval_kit", "utils.convert_torch", "render",
              "render.lighting", "render.rasterizer", "cli.demo",
              "cli.infer", "bench", "ops.fps", "data.interhand_new",
              "train.priors", "models.csp", "ops.crop_resize",
              "train.mano_branch"):
        assert f"pdfnet_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("field,value", [
    ("knn_method", "approx"), ("use_img_attn", True), ("s2d_stem", True),
    ("patch_heads", True)])
def test_build_model_takes_the_handnet_options(field, value):
    """The values the port once refused build a model and run its eval and
    train steps on the CPU at a small size (res 192, where the image
    attention's grid fits); ``tests/test_torch_options.py`` holds them to
    JAX."""
    import torch
    from pdfnet_tpu_torch import (create_train_state, load_loss_consts,
                                  make_batch, make_eval_step,
                                  make_train_step)
    torch.set_num_threads(1)
    cfg = PortConfig(default_resolution=192, compute_dtype="float32",
                     sample_num=256, sample_num_level1=128,
                     sample_num_level2=128, knn_k=8).replace(**{field: value})
    model = build_model(cfg, device="cpu")
    consts = load_loss_consts("cpu")
    batch = make_batch(cfg, 2, seed=0)
    out = make_eval_step(cfg, model, consts)(batch)
    assert out["verts_pred"].shape == (2, 2, 778, 3)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    stats = make_train_step(cfg, model, consts)(
        create_train_state(cfg, model), batch, 0, 1e-4)
    assert bool(torch.isfinite(stats["loss"]))


@pytest.mark.parametrize("variant", [
    dict(sample_strategy="FPS"), dict(input_feature_num=6),
    dict(sample_strategy="FPS", input_feature_num=6)])
def test_build_model_takes_normals_and_fps(variant):
    """``sample_strategy="FPS"`` and ``input_feature_num=6`` build, and the
    JAX set abstraction's variables at the same widths cross onto the
    port's parameters shape for shape (``convert.from_flax`` checks every
    leaf): the six-channel clouds widen the level-0 SFT and the level-1
    MLP, and nothing else of the model depends on either value."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pdfnet_tpu.models.pointnet import PointNetPlus as JaxPointNetPlus
    from pdfnet_tpu_torch import convert
    cfg = PortConfig(default_resolution=64, sample_num=256,
                     sample_num_level1=128, sample_num_level2=128, knn_k=8,
                     **variant)
    model = build_model(cfg, device="cpu")
    c = cfg.input_feature_num
    jmod = JaxPointNetPlus(knn_k=8, num_level1=128, num_level2=128,
                           input_feature_num=c, resolution=64,
                           dtype=jnp.float32)
    args = (np.zeros((1, 2, 256, c), np.float32),
            [np.zeros((1, 64 // s, 64 // s, w), np.float32)
             for s, w in ((1, 3), (2, 64), (4, 256))],
            np.zeros((1, 2, 256), np.int32), False)
    # one compile (an eager init compiles each primitive on its own)
    variables = jax.jit(jmod.init, static_argnums=4)(jax.random.PRNGKey(0),
                                                     *args)
    pointnet = model.encoder.pointnet
    pointnet.load_state_dict(convert.from_flax(variables, pointnet))
    assert pointnet.mlp1.fc0.in_features == c
    assert pointnet.sft0.scale1.out_features == c


@pytest.mark.parametrize("arch", ["resnet50", "csp_18"])
def test_trainer_takes_zero1_but_not_for_csp(arch):
    """``zero1_opt_sharding``, once refused, builds the HandNet trainer
    (its moments are split over the ranks of a process group; in one
    process it replicates, as a one-device JAX mesh does); the CSP
    detector raises JAX's ValueError (``trainer.py:110-113``) before it
    builds a model."""
    from pdfnet_tpu_torch.train.trainer import Trainer
    cfg = PortConfig(arch=arch, zero1_opt_sharding=True)
    if arch.startswith("csp"):
        with pytest.raises(ValueError, match="zero1_opt_sharding is only "
                                             "wired for the flagship"):
            Trainer(cfg, device="cpu")
    else:
        assert Trainer(cfg, device="cpu").train_step is not None


@pytest.mark.parametrize("arch", ["csp_50", "csp_18"])
def test_trainer_builds_the_csp_archs(arch):
    """The CSP archs, which the trainer once refused, build the CSP
    detector with its MANO constants and train step, and no eval step
    (``tests/test_torch_csp.py`` trains and holds them to JAX)."""
    from pdfnet_tpu_torch.models.csp import CSPNet
    from pdfnet_tpu_torch.train.mano_branch import ManoBranchConsts
    from pdfnet_tpu_torch.train.trainer import Trainer
    trainer = Trainer(PortConfig(arch=arch), device="cpu")
    assert isinstance(trainer.model, CSPNet)
    assert isinstance(trainer.consts, ManoBranchConsts)
    assert trainer.eval_step is None and trainer.train_step is not None


@pytest.mark.parametrize("field", ["image_summary", "photometric_loss"])
def test_trainer_writes_image_summaries(field, tmp_path):
    """With either value the trainer trains and writes its render grid
    through the logger every ``image_summary_every`` steps."""
    import numpy as np
    import torch
    from pdfnet_tpu_torch import make_batch
    from pdfnet_tpu_torch.train.trainer import Logger, Trainer
    torch.set_num_threads(1)
    cfg = PortConfig(default_resolution=64, compute_dtype="float32",
                     sample_num=256, sample_num_level1=128,
                     sample_num_level2=128, knn_k=8, batch_size=2,
                     image_summary_every=2, **{field: True})
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    logger = Logger(str(tmp_path), cfg)
    batches = [make_batch(cfg, 2, seed=s) for s in range(3)]
    stats = trainer.run_epoch(0, iter(batches), logger)
    logger.close()
    assert np.isfinite(stats["loss"])
    assert ("photometric_loss" in stats) == (field == "photometric_loss")
    images = sorted(os.listdir(tmp_path / "images"))
    assert images == ["train_00000001.png", "train_00000003.png"]


@pytest.mark.parametrize("argv", [
    ["--coordinator", "localhost:1", "--num_processes", "2",
     "--process_id", "1"],
    ["--coordinator", "10.0.0.1:29500", "--num_processes", "4",
     "--process_id", "0"],
    ["--coordinator", "localhost:1", "--num_processes", "1",
     "--process_id", "0"]])
def test_cli_takes_multi_process_flags(argv):
    """``check_args`` passes every flag set that names one rank of a
    group (it once refused each flag)."""
    from pdfnet_tpu_torch.cli.main import build_argparser, check_args
    args = build_argparser().parse_args(argv)
    check_args(args)
    assert 0 <= args.process_id < args.num_processes


@pytest.mark.parametrize("kw,name", [
    (dict(sample_num=3072, sample_num_level1=3072, knn_k=3073),
     "sample_num=3072"),
    (dict(knn_k=600), "sample_num_level1=512")])
def test_build_model_refuses_the_remaining_limits(kw, name):
    """k above a level's points cannot be selected, at any width (k = N =
    3072, past the block's shared memory, is taken: the selection
    spills)."""
    with pytest.raises(ValueError, match=name):
        build_model(PortConfig().replace(**kw), device="cpu")


@pytest.mark.parametrize("knn_method", ["topk", "pallas", "pallas_fused",
                                        "pallas_sa"])
def test_model_honours_knn_method_and_fused_trunk(knn_method):
    """The values the port implements reach the modules that read them
    (``build_model`` is ``HandNet`` plus the weight initialisation)."""
    cfg = PortConfig(default_resolution=64, sample_num=256,
                     sample_num_level1=128, sample_num_level2=128, knn_k=8,
                     knn_method=knn_method, fused_trunk=True)
    model = HandNet(cfg)
    assert model.encoder.pointnet.knn_method == knn_method
    assert model.encoder.resnet.fused_eval


@pytest.mark.parametrize("entry", ["pdfnet_tpu_torch.models.handnet:build_model",
                                   "pdfnet_tpu_torch.train.loss:load_loss_consts",
                                   "pdfnet_tpu_torch.mano.layer:load_mano_consts",
                                   "pdfnet_tpu_torch.train.trainer:Trainer",
                                   "pdfnet_tpu_torch.train.trainer:fit",
                                   "pdfnet_tpu_torch.bench:main",
                                   "pdfnet_tpu_torch.models.csp:build_csp_model",
                                   "pdfnet_tpu_torch.train.mano_branch:"
                                   "load_mano_branch_consts"])
def test_entry_points_default_to_the_card(entry):
    """Every public loader or model constructor that takes a device runs on
    the card unless the caller asks for the CPU."""
    import importlib
    import inspect
    module, name = entry.split(":")
    fn = getattr(importlib.import_module(module), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
