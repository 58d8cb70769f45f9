"""Package hygiene of the PyTorch port: it imports nothing of JAX or of the
JAX package, and its ``Config`` mirrors ``pdfnet_tpu.config.Config``."""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import pdfnet_tpu_torch
from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu_torch.config import Config as PortConfig

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
