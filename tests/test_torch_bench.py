"""The port's bench entry (``python -m pdfnet_tpu_torch.bench``) on the
CPU at a tiny size, in each of ``bench.py``'s three modes: one JSON line
on stdout with ``bench.py``'s metric name, keys and unit, a positive value
and a null ``vs_baseline``; the flags are ``bench.py``'s, ``--s2d_stem``
and ``--knn approx`` included.

The CPU is reached through ``main``'s ``device`` argument; the size is cut
by giving the bench a ``Config`` with the small test shapes (float32, res
64, 256 points, 128/128 centers, k=8), since ``bench.py`` has no flag for
them.
"""

import json

import pytest
import torch

import pdfnet_tpu_torch.config as port_config
from pdfnet_tpu_torch import bench

from test_torch_eval_step import SMALL
from test_torch_threads import one_torch_thread  # noqa: F401

TINY = ["--batch", "2", "--iters", "2", "--warmup", "1", "--res", "64",
        "--train_batch", "2"]


@pytest.fixture
def small_config(monkeypatch):
    full = port_config.Config
    monkeypatch.setattr(port_config, "Config",
                        lambda **kw: full(**{**kw, **SMALL}))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags,metric,unit", [
    ([], "rgbd_inference_frames_per_sec_per_chip", "frames/s"),
    (["--self_contained", "--knn", "pallas", "--fused_trunk"],
     "rgbd_selfcontained_frames_per_sec_per_chip", "frames/s"),
    (["--self_contained"], "rgbd_selfcontained_frames_per_sec_per_chip",
     "frames/s"),
    (["--train"], "train_samples_per_sec_per_chip", "samples/s")])
def test_bench_prints_one_json_line(flags, metric, unit, small_config,
                                    capsys):
    line = bench.main(flags + TINY, device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    got = json.loads(lines[0])
    assert got == line
    assert list(got) == ["metric", "value", "unit", "vs_baseline"]
    assert got["metric"] == metric and got["unit"] == unit
    assert got["value"] > 0 and got["vs_baseline"] is None
    # the launch counts go to stderr; CPU tensors launch no kernel
    launches = json.loads(err.strip().splitlines()[-1].split(" ", 1)[1])
    assert "sa_group_l1" in launches and not any(launches.values())


def test_flags_are_bench_pys():
    """bench.py's flags and defaults (bench.py:19-37)."""
    args = bench.build_parser().parse_args([])
    assert vars(args) == dict(batch=96, iters=60, warmup=3, res=384,
                              knn="pallas_sa", fused_trunk=False,
                              s2d_stem=False, self_contained=False,
                              train=False, train_batch=8)


@pytest.mark.parametrize("flags,field,value", [
    (["--s2d_stem"], "s2d_stem", True),
    (["--knn", "approx"], "knn_method", "approx")])
def test_runs_with(flags, field, value, small_config, capsys, monkeypatch):
    """The eval mode with the flag reaches the model's Config and prints
    its line."""
    from pdfnet_tpu_torch.models import handnet
    seen = []
    build = handnet.build_model
    monkeypatch.setattr(handnet, "build_model",
                        lambda cfg, **kw: seen.append(cfg) or build(cfg, **kw))
    line = bench.main(flags + TINY, device="cpu")
    assert getattr(seen[0], field) == value
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert line["value"] > 0

