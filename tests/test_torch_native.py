"""The port's C++ host helpers (``pdfnet_tpu_torch.native``) against their
numpy versions and against the JAX package's build of the same source.

The port builds its own copy of ``fastops.cpp`` into
``pdfnet_tpu_torch/_build/``; the JAX package builds its copy into its
package.  On the same inputs and seed both give the same bytes: the same
uniform subset (one ``std::mt19937_64`` stream), the same float32 splat.
The numpy versions draw another uniform subset, so against them the tests
hold the native sampler to the same semantics (the band, the validity, the
backprojection of the chosen pixels), and the splat to 1e-6.
"""

import os

import numpy as np
import pytest

from pdfnet_tpu import native as jax_native
from pdfnet_tpu.data.cloud import sample_hand_cloud as jax_sample
from pdfnet_tpu.data.targets import centernet_targets as jax_targets

from pdfnet_tpu_torch import native
from pdfnet_tpu_torch.data.cloud import backproject_np, sample_hand_cloud
from pdfnet_tpu_torch.data.targets import (centernet_targets, draw_gaussian,
                                           gaussian2d)
from test_torch_threads import one_torch_thread  # noqa: F401

K = np.array([[120.0, 0, 64], [0, 120.0, 64], [0, 0, 1]], np.float32)


def _depth(n_pixels_side=50, seed=0):
    rng = np.random.RandomState(seed)
    depth = np.zeros((128, 128), np.float32)
    s = n_pixels_side
    depth[40:40 + s, 30:30 + s] = 0.5 + rng.rand(s, s).astype(np.float32) * 0.02
    return depth


@pytest.fixture(scope="module")
def jax_native_built():
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")


@pytest.mark.parametrize("side,num_points", [(50, 256), (12, 256), (8, 64)])
def test_native_cloud_equals_jax_native(jax_native_built, side, num_points):
    """More in-band pixels than points (a subset), fewer (wrap padding and
    a shuffle), and too few (an invalid hand): equal bytes, equal ok."""
    depth = _depth(side)
    got = sample_hand_cloud(depth, K, num_points, np.random.RandomState(1),
                            native=True)
    want = jax_sample(depth, K, num_points, np.random.RandomState(1),
                      use_native=True)
    assert got[2] == want[2] == (side * side >= 100)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_native_cloud_semantics_against_numpy():
    depth = _depth()
    c_nat, p_nat, ok_nat = sample_hand_cloud(depth, K, 256,
                                             np.random.RandomState(1),
                                             native=True)
    c_np, p_np, ok_np = sample_hand_cloud(depth, K, 256,
                                          np.random.RandomState(1))
    assert ok_nat and ok_np
    valid = set(np.flatnonzero(depth > 0))
    assert set(c_nat.tolist()) <= valid and set(c_np.tolist()) <= valid
    assert len(set(c_nat.tolist())) == 256          # a subset, no repeats
    xyz = backproject_np(depth, K).reshape(-1, 3)
    np.testing.assert_allclose(p_nat, xyz[c_nat], atol=1e-5)
    assert np.all((p_nat[:, 2] > 0.4) & (p_nat[:, 2] < 0.6))


def test_native_cloud_invalid_hand():
    c, p, ok = sample_hand_cloud(np.zeros((64, 64), np.float32),
                                 np.eye(3, dtype=np.float32), 128,
                                 np.random.RandomState(0), native=True)
    assert not ok and c.sum() == 0 and p.sum() == 0


def test_deterministic_sampling_takes_the_numpy_path():
    """``deterministic`` has one definition (the first in-band pixels); the
    native flag does not change it."""
    depth = _depth()
    a = sample_hand_cloud(depth, K, 256, np.random.RandomState(0),
                          deterministic=True, native=True)
    b = sample_hand_cloud(depth, K, 256, np.random.RandomState(5),
                          deterministic=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("center,radius", [((20, 30), 5), ((1, 62), 4),
                                           ((63, 0), 0), ((70, 10), 3)])
def test_native_gaussian_equals_jax_and_numpy(jax_native_built, center,
                                              radius):
    """Centers inside, on the edge and outside the map: the JAX build's
    bytes, and the numpy splat within 1e-6."""
    hm = np.zeros((64, 64), np.float32)
    hm[30:34, 18:22] = 0.5                  # max-compositing over content
    got, want, ref = hm.copy(), hm.copy(), hm.copy()
    draw_gaussian(got, center, radius, native=True)
    jax_native.draw_gaussian_native(want, center, radius)
    draw_gaussian(ref, center, radius)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_native_gaussian_peak_and_layout():
    hm = np.zeros((64, 64), np.float32)
    draw_gaussian(hm, (20, 30), 5, native=True)
    g = gaussian2d((11, 11), sigma=11 / 6.0)
    np.testing.assert_allclose(hm[25:36, 15:26], g, atol=1e-6)
    assert hm.max() == pytest.approx(1.0)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.draw_gaussian_native(np.zeros((8, 8)), (2, 2), 1)


def test_centernet_targets_native_equals_jax(jax_native_built):
    rng = np.random.RandomState(3)
    lms_l = rng.uniform(40, 200, (21, 2)).astype(np.float32)
    lms_r = rng.uniform(150, 330, (21, 2)).astype(np.float32)
    got = centernet_targets(lms_l, lms_r, 1, 1, 384, 4, native=True)
    want = jax_targets(lms_l, lms_r, 1, 1, 384, 4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_writes_into_the_port_and_raises_on_failure(tmp_path,
                                                          monkeypatch):
    """The library lives under ``pdfnet_tpu_torch/_build/``, named by the
    source's hash; a source that does not compile raises with g++'s
    message instead of falling back to numpy."""
    native.get_lib()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    bad = tmp_path / "fastops.cpp"
    bad.write_text("extern \"C\" int broken( { }\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()


def test_library_path_is_keyed_by_the_host(monkeypatch):
    """A library built with ``-march=native`` is named by the host as well
    as by the source and flags: another host key gives another file, the
    same key the same file."""
    here = native.library_path()
    assert native.library_path() == here
    monkeypatch.setattr(native, "host_key", lambda: "another host\n")
    there = native.library_path()
    assert there != here and native.library_path() == there
    assert os.path.dirname(there) == native.BUILD_DIR
    monkeypatch.setattr(native, "host_key", lambda: "a third host\n")
    assert native.library_path() not in (here, there)
