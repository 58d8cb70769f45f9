"""PyTorch/CUDA port of ``pdfnet_tpu`` for NVIDIA Hopper (H100).

Entry points of the batched RGB-D eval path:

    from pdfnet_tpu_torch import Config, build_model, load_loss_consts, make_eval_step
    cfg = Config()
    model = build_model(cfg)                 # on the card; raises without one
    step = make_eval_step(cfg, model, load_loss_consts())
    out = step(batch)                        # the bench's batch dict

The package imports torch and numpy only, never ``jax`` or ``pdfnet_tpu``.
"""

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.handnet import HandNet, build_model
from pdfnet_tpu_torch.train.loss import load_loss_consts
from pdfnet_tpu_torch.train.step import make_eval_step

__all__ = ["Config", "HandNet", "build_model", "load_loss_consts",
           "make_eval_step"]
