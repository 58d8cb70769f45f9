"""Batched RGB-D eval step (port of ``make_eval_step``,
``pdfnet_tpu/train/step.py:195-205``)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.handnet import HandNet
from pdfnet_tpu_torch.train.loss import LossConsts, eval_outputs


def make_eval_step(cfg: Config, model: HandNet, consts: LossConsts
                   ) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """A callable on the bench's batch dict (``bench.py:57-68``: input,
    choose, cloud, K_new, ...; numpy arrays or tensors) that runs the model
    under ``torch.inference_mode()`` on the model's device and returns
    ``eval_outputs``.  Returns before the device finishes, like any CUDA
    call; synchronize to time it."""
    device = next(model.parameters()).device

    def to_device(v):
        t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        return t.to(device, non_blocking=True)

    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            b = {k: to_device(v) for k, v in batch.items()}
            result, params, hand_dicts, other = model(
                b["input"], b["choose"], b["cloud"])
            return eval_outputs(cfg, consts, result, params, hand_dicts,
                                other, b)

    return eval_step
