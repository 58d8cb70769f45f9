"""True float32 on the card: TF32 off for float32 work.

A float32 convolution goes through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False (its default is True), and a
float32 matmul through cuBLAS in TF32 where
``torch.backends.cuda.matmul.allow_tf32`` is True.  TF32 keeps about three
decimal digits; the port's float32 contract is true float32, the JAX
reference's ``Precision.HIGHEST``.  bf16 work is unaffected: its products
are bf16 already.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def tf32_off() -> None:
    """Both TF32 flags off for the rest of the process (the CLIs and the
    bench entry, before they build a model)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def float32_precision(compute_dtype: str) -> Iterator[None]:
    """Both TF32 flags off inside when ``compute_dtype`` is "float32" (the
    steps enter it around their forward and backward); the caller's flags
    are restored on exit.  Any other compute dtype leaves them alone."""
    if compute_dtype != "float32":
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    tf32_off()
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
