"""Host-side C++ helpers of the data pipeline (port of
``pdfnet_tpu/native``): ``sample_hand_cloud_native`` and
``draw_gaussian_native``.

The port keeps its own copy of ``fastops.cpp`` and builds it with ``g++`` at
first use into ``pdfnet_tpu_torch/_build/``, named by a hash of the source,
the flags and the host (``host_key``): ``-march=native`` code built on one
CPU can abort with an illegal instruction on another, and the working tree
moves between machines with ``_build/`` in it.  A failed build raises with the compiler's message: the numpy
versions (``data.cloud.sample_hand_cloud``, ``data.targets.draw_gaussian``)
are chosen explicitly by their callers, never in place of a failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def host_key() -> str:
    """This host as the build's key: the boot id, else the first line of
    ``/proc/cpuinfo``, else the platform's processor or machine name (the
    rule of ``pdfnet_tpu/utils/cache.py``).  A move to another machine
    implies a reboot, so a library is reused only within the boot that
    built it."""
    for src in ("/proc/sys/kernel/random/boot_id", "/proc/cpuinfo"):
        try:
            with open(src) as f:
                line = f.readline()
        except OSError:
            continue
        if line:
            return line
    return platform.processor() or platform.machine()


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(host_key().encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libfastops-{digest.hexdigest()[:16]}.so")


def get_lib() -> ctypes.CDLL:
    """The built library, compiled on the first call; raises RuntimeError
    with the compiler's output if ``g++`` fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = library_path()
        if not os.path.exists(target):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{target}.{os.getpid()}.tmp"
            try:
                out = subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp],
                                     capture_output=True, text=True,
                                     timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"native: g++ did not run: {e}") from e
            if out.returncode != 0:
                raise RuntimeError(f"native: g++ failed building {_SRC}:\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(target)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.sample_hand_cloud.restype = ctypes.c_int
        lib.sample_hand_cloud.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64), f32p]
        lib.draw_gaussian.restype = None
        lib.draw_gaussian.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _LIB = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sample_hand_cloud_native(
    masked_depth: np.ndarray, K: np.ndarray, num_points: int,
    seed: int, min_pixels: int = 100,
    z_min: float = 0.2, z_max: float = 2.5, band: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """C++ version of ``data.cloud.sample_hand_cloud``: the same band and
    padding, a uniform random subset from a ``std::mt19937_64`` seeded with
    ``seed`` (another stream than numpy's) -> (choose, cloud, ok)."""
    lib = get_lib()
    H, W = masked_depth.shape
    depth = np.ascontiguousarray(masked_depth, np.float32)
    k_inv = np.ascontiguousarray(np.linalg.inv(K), np.float32)
    choose = np.zeros(num_points, np.int64)
    cloud = np.zeros((num_points, 3), np.float32)
    ok = lib.sample_hand_cloud(
        _fptr(depth), H, W, _fptr(k_inv), num_points, min_pixels,
        z_min, z_max, band, ctypes.c_uint64(seed),
        choose.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _fptr(cloud))
    return choose, cloud, bool(ok)


def draw_gaussian_native(heatmap: np.ndarray, center, radius: int) -> None:
    """In-place max-composited gaussian splat of a float32 C-contiguous
    (H, W) heatmap (``draw_umich_gaussian``, its gaussian in float32)."""
    if heatmap.dtype != np.float32 or not heatmap.flags.c_contiguous:
        raise ValueError("draw_gaussian_native: needs a C-contiguous float32 "
                         "heatmap")
    H, W = heatmap.shape
    get_lib().draw_gaussian(_fptr(heatmap), H, W, int(center[0]),
                            int(center[1]), int(radius))
