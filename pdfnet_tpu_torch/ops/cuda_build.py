"""Builds the port's CUDA sources (``pdfnet_tpu_torch/csrc/*.cu``) with nvcc
into shared libraries with a plain C interface, loaded through ctypes.

Each source compiles on its own into ``pdfnet_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its text, the shared headers and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  :func:`build` starts one
nvcc per missing source, all at once, and waits for all of them.  Nothing
here runs at import: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("sa_group.cu", "sa_mlp.cu", "trunk_block.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source and need the CUDA toolkit")
    return path


def library_path(source: str) -> str:
    """The library of ``source``, named by a hash of its text, the shared
    headers' (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns the compiler's output (ptxas register/shared-memory report) per
    compiled source; raises RuntimeError with the output if any build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: Dict[str, Tuple[subprocess.Popen, str, str]] = {}
    nvcc = None
    for src in sources:
        target = library_path(src)
        if os.path.exists(target):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    logs, failed = {}, []
    for src, (proc, tmp, target) in procs.items():
        try:
            logs[src], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            logs[src], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[s] for s in failed))
    return logs


def library(source: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if needed), with
    ``argtypes`` set from ``signatures`` and an int return code."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(library_path(source))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[source] = lib
        return lib
