"""The port's host utilities: ``utils/vis.py`` (the eval dumps of
``--vis_every``) equal to the JAX package's, and ``utils/profiler.py``'s
``StepProfiler`` on ``torch.profiler``: the data-wait and step meters, and
a trace window written as a Chrome trace.
"""

import json
import os
import time

import numpy as np
import torch

from pdfnet_tpu.utils import vis as jax_vis

from pdfnet_tpu_torch.utils import vis
from pdfnet_tpu_torch.utils.profiler import StepProfiler
from test_torch_threads import one_torch_thread  # noqa: F401


def test_vis_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    joints = rng.uniform(2, 60, (21, 2)).astype(np.float32)
    np.testing.assert_array_equal(vis.draw_hand_skeleton(img.copy(), joints),
                                  jax_vis.draw_hand_skeleton(img.copy(),
                                                             joints))
    np.testing.assert_array_equal(
        vis.draw_landmarks(img.copy(), joints, color=(0, 255, 0)),
        jax_vis.draw_landmarks(img.copy(), joints, color=(0, 255, 0)))
    inp = rng.randn(64, 64, 3).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_array_equal(vis.denormalize_image(inp, mean, std),
                                  jax_vis.denormalize_image(inp, mean, std))
    verts = rng.randn(10, 3).astype(np.float32)
    faces = rng.randint(0, 10, (4, 3))
    vis.write_obj(str(tmp_path / "a.obj"), verts, faces)
    jax_vis.write_obj(str(tmp_path / "b.obj"), verts, faces)
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj"
                                                 ).read_bytes()


def test_step_profiler_meters():
    prof = StepProfiler(sync=True)
    prof.reset_epoch()
    for _ in range(3):
        time.sleep(0.02)
        prof.data_tick()
        with prof.step():
            time.sleep(0.01)
    s = prof.summary()
    assert prof.batch_time.count == prof.data_time.count == 3
    assert 0.015 < s["data_time_avg_s"] < 0.2
    assert 0.008 < s["step_time_avg_s"] < 0.2
    assert prof.step_num == 3 and not prof.tracing


def test_step_profiler_trace_window(tmp_path):
    """Steps 1 and 2 of 4 are traced; the window closes itself and writes
    its Chrome trace, which names the steps it covered."""
    prof = StepProfiler(str(tmp_path), start_step=1, num_steps=2)
    x = torch.randn(64, 64)
    for i in range(4):
        with prof.step():
            assert prof.tracing == (i in (1, 2))
            (x @ x).sum()
    assert not prof.tracing
    path = tmp_path / "trace_1.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"train_step_1", "train_step_2"} <= names
    assert "train_step_0" not in names and "train_step_3" not in names
    prof.close()                       # idempotent


def test_step_profiler_close_ends_an_open_window(tmp_path):
    prof = StepProfiler(str(tmp_path), start_step=0, num_steps=10)
    with prof.step():
        pass
    assert prof.tracing
    prof.close()
    assert not prof.tracing and os.path.exists(tmp_path / "trace_0.json")
