"""The port's train/eval CLI (``pdfnet_tpu_torch.cli.main``).

- The flag surface mirrors ``tests/test_cli_flags.py``: every field of the
  port's ``Config`` is reachable, defaults and overrides round-trip, and
  the parser has the JAX CLI's flags and choices.
- The values the port has no path for are refused by name before any data
  or model is built: the multi-process flags, ``--no-depth``, and the
  Config values refused by the model and the trainer.
- ``--sample_strategy FPS`` and ``--input_feature_num 6`` train a step,
  and the CLI's dataset gives the JAX dataset's batch for them;
  ``--photometric_loss`` and ``--image_summary`` train steps on the H2O
  fixture and write the render grids.
- ``main(["--cpu", "--mode", "train", ..., "--steps", "2"])`` on the H2O
  fixture tree, then ``--mode test --load_model`` of its checkpoint, writes
  ``H2O-val.txt`` and a ``hand_poses.json`` with the JAX CLI's structure
  (``{"modality": "RGBD", "<action id>": {"<frame>.txt": [126 floats]}}``,
  one entry a record), the model restored bit for bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pdfnet_tpu.cli.main import build_argparser as jax_argparser

from pdfnet_tpu_torch.cli.main import build_argparser, config_from_args, main
from pdfnet_tpu_torch.config import Config

from test_h2o_dataset import h2o_tree  # noqa: F401  (fixture reuse)
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = ["--default_resolution", "64", "--sample_num", "256",
         "--sample_num_level1", "128", "--sample_num_level2", "128",
         "--knn_k", "8", "--compute_dtype", "float32", "--num_workers", "2"]


def test_every_config_field_is_cli_reachable():
    dests = {a.dest for a in build_argparser()._actions}
    missing = [f.name for f in dataclasses.fields(Config)
               if f.name not in dests]
    assert not missing, f"Config fields unreachable from the CLI: {missing}"


def test_flags_and_choices_match_the_jax_cli():
    def surface(ap):
        return {a.dest: (tuple(a.option_strings), a.default,
                         tuple(a.choices or ())) for a in ap._actions}
    assert surface(build_argparser()) == surface(jax_argparser())


def test_defaults_round_trip():
    assert config_from_args(build_argparser().parse_args([])) == Config()


def test_overrides_round_trip():
    argv = ["--no-reproj_loss", "--no-brightness", "--off",
            "--freeze_bn_stats", "--skip_nonfinite_updates",
            "--sample_deterministic", "--knn_method", "topk",
            "--sample_num", "2048", "--knn_k", "128", "--lr_step", "30,60",
            "--compute_dtype", "float32", "--gcn_out_dim", "256,128,64",
            "--eval_batch_size", "48", "--off_weight", "50",
            "--profile_sync", "--profile_dir", "p"]
    cfg = config_from_args(build_argparser().parse_args(argv))
    assert cfg.reproj_loss is False and cfg.brightness is False
    assert cfg.off and cfg.freeze_bn_stats and cfg.skip_nonfinite_updates
    assert cfg.sample_deterministic and cfg.knn_method == "topk"
    assert (cfg.sample_num, cfg.knn_k) == (2048, 128)
    assert cfg.lr_step == (30, 60) and cfg.compute_dtype == "float32"
    assert cfg.gcn_out_dim == (256, 128, 64) and cfg.eval_batch_size == 48
    assert cfg.off_weight == 50 and cfg.profile_sync
    assert cfg.profile_dir == "p"
    assert set(cfg.heads) == {"hm", "wh", "off_hm", "off_lms"}


@pytest.mark.parametrize("argv,name", [
    (["--coordinator", "localhost:1234"], "--coordinator needs"),
    (["--num_processes", "2"], "--num_processes without --coordinator"),
    (["--process_id", "0"], "--process_id without --coordinator")])
def test_multi_process_flags_must_name_one_rank(argv, name):
    """The multi-process flags train (``tests/test_torch_parallel.py``);
    a set that names no rank of a group is refused before anything
    starts."""
    with pytest.raises(ValueError, match=name):
        main(argv + ["--cpu", "--synthetic"])


def test_no_depth_is_refused():
    with pytest.raises(SystemExit, match="--no-depth"):
        main(["--no-depth", "--cpu", "--synthetic"])


@pytest.mark.parametrize("argv,exc,name", [
    (["--mode", "test", "--arch", "csp_50", "--synthetic"],
     NotImplementedError, "mesh evaluation"),
    (["--zero1_opt_sharding", "--arch", "csp_18", "--synthetic"],
     ValueError, "zero1_opt_sharding is only wired"),
    (["--knn_k", "600"], ValueError, "knn_k=600"),
    (["--sample_num", "4096", "--sample_num_level1", "4096", "--knn_k",
      "4096"], ValueError, "MAX_SMEM")])
def test_config_values_are_refused_at_parse(argv, exc, name, tmp_path):
    """Refused before any data is read (the cache path does not exist; a
    CSP arch's evaluation raises, as JAX's does, before its first
    synthetic batch)."""
    with pytest.raises(exc, match=name):
        main(argv + ["--cpu", "--cache_path", str(tmp_path / "none")])


def test_train_then_test_writes_the_score_files(h2o_tree, tmp_path):
    out = str(tmp_path / "out")
    common = ["--cpu", "--cache_path", h2o_tree, "--pre_fix", h2o_tree,
              "--output_path", out, "--batch_size", "1",
              "--eval_batch_size", "2"] + SMALL
    trained = main(["--mode", "train", "--num_epochs", "1", "--steps", "2",
                    "--eval_every", "1", "--save_every", "1"] + common)
    assert trained.state.step == 2
    ckpt = os.path.join(out, "ckpt", "default", "model_0")
    assert os.path.exists(ckpt)
    tester = main(["--mode", "test", "--load_model", ckpt] + common)
    for (n, p), (m, q) in zip(trained.model.named_parameters(),
                              tester.model.named_parameters()):
        assert n == m and torch.equal(p, q), n

    with open(os.path.join(out, "H2O-val.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "eval " and len(lines) == 9
    assert all(np.isfinite(float(x.split(": ")[1])) for x in lines[1:])
    with open(os.path.join(out, "hand_poses.json")) as f:
        sub = json.load(f)
    # the fixture's 3 test records: action id 1, frames 0..2
    assert list(sub) == ["modality", "1"] and sub["modality"] == "RGBD"
    assert sorted(sub["1"]) == ["000000.txt", "000001.txt", "000002.txt"]
    assert all(len(v) == 126 and np.isfinite(v).all()
               for v in sub["1"].values())


@pytest.mark.parametrize("flag", ["--photometric_loss", "--image_summary"])
def test_train_writes_render_grids(h2o_tree, tmp_path, flag):
    """Two train steps of batch 1 at 192x192 (the fixture's hands are valid
    there) with ``--image_summary_every 1``: finite parameters, the photometric
    terms among the logged stats only with ``--photometric_loss``, and one
    ``input | pred | gt`` grid a step under ``logs/``."""
    import cv2
    out = str(tmp_path / "out")
    trainer = main(["--mode", "train", "--num_epochs", "1", "--steps", "2",
                    "--eval_every", "0", "--save_every", "0", "--cpu",
                    "--cache_path", h2o_tree, "--pre_fix", h2o_tree,
                    "--output_path", out, "--batch_size", "1",
                    "--sample_num", "256", "--sample_num_level1", "128",
                    "--sample_num_level2", "32", "--knn_k", "8",
                    "--compute_dtype", "float32", "--num_workers", "2",
                    "--default_resolution", "192", "--image_summary_every",
                    "1", flag])
    assert trainer.state.step == 2
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
    grids = sorted(os.path.join(d, f) for d, _, fs in os.walk(out)
                   for f in fs if f.endswith(".png"))
    assert [os.path.basename(g) for g in grids] == ["train_00000001.png",
                                                    "train_00000002.png"]
    assert cv2.imread(grids[0]).shape == (192, 3 * 192, 3)
    logs = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs
            if f == "log.jsonl"]
    first = json.loads(open(logs[0]).readline())
    assert ("photometric_loss" in first) == (flag == "--photometric_loss")


@pytest.mark.parametrize("flags", [["--sample_strategy", "FPS"],
                                   ["--input_feature_num", "6"]])
def test_train_step_with_fps_or_normals(h2o_tree, tmp_path, flags):
    """``--sample_strategy FPS`` and ``--input_feature_num 6`` run: one
    train step at 192x192 (where the fixture's hands are valid), finite
    parameters after its update, the model's level-1 width following the
    flag; and the CLI's
    dataset gives the JAX dataset's first batch of the same flags, key by
    key."""
    from pdfnet_tpu.config import Config as JaxConfig
    from pdfnet_tpu.data.h2o import H2ODataset as JaxDataset
    from pdfnet_tpu_torch.data.h2o import H2ODataset
    from test_torch_h2o import _compare
    out = str(tmp_path / "out")
    argv = (["--cpu", "--cache_path", h2o_tree, "--pre_fix", h2o_tree,
             "--output_path", out, "--batch_size", "2", "--sample_num",
             "256", "--sample_num_level1", "128", "--sample_num_level2", "32",
             "--knn_k", "8", "--compute_dtype", "float32", "--num_workers",
             "2", "--default_resolution", "192"] + flags)
    trainer = main(["--mode", "train", "--num_epochs", "1", "--steps", "1",
                    "--eval_every", "0", "--save_every", "0"] + argv)
    assert trainer.state.step == 1
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
    cfg = trainer.cfg
    c = cfg.input_feature_num
    assert trainer.model.encoder.pointnet.mlp1.fc0.in_features == c
    assert cfg.sample_strategy == ("FPS" if "FPS" in flags else "random")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(Config)}
    got = next(H2ODataset(cfg, "train").batches(2, 0))
    want = next(JaxDataset(JaxConfig(**fields), "train").batches(2, 0))
    assert got["cloud"].shape == (2, 2, 256, c) and want["valid"].sum() > 0
    _compare(got, want)
