"""PyTorch/CUDA port of ``pdfnet_tpu`` for NVIDIA Hopper (H100).

Entry points of the batched RGB-D eval step, the self-contained RGB-D
serving path and the train step:

    from pdfnet_tpu_torch import (Config, build_model, create_train_state,
                                  load_loss_consts, make_batch,
                                  make_eval_step, make_train_step)
    cfg = Config()
    model = build_model(cfg)                 # on the card; raises without one
    consts = load_loss_consts()
    out = make_eval_step(cfg, model, consts)(batch)   # the bench's batch dict

    # serving from RGB + depth alone: clouds from the predicted masks
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = eval_outputs(cfg, consts, *infer_rgbd(model, img, depth, K, valid,
                                                gen), {"K_new": K})

    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, consts)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = step(state, make_batch(cfg, 8), epoch=0, lr=cfg.lr, generator=gen)

The package imports torch and numpy only, never ``jax`` or ``pdfnet_tpu``.
"""

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data.synthetic import make_batch
from pdfnet_tpu_torch.models.handnet import HandNet, build_model, infer_rgbd
from pdfnet_tpu_torch.train.loss import (compute_loss, eval_outputs,
                                         load_loss_consts)
from pdfnet_tpu_torch.train.step import (TrainState, create_train_state,
                                         lr_at_epoch, make_eval_step,
                                         make_train_step)

__all__ = ["Config", "HandNet", "TrainState", "build_model", "compute_loss",
           "create_train_state", "eval_outputs", "infer_rgbd",
           "load_loss_consts", "lr_at_epoch", "make_batch", "make_eval_step",
           "make_train_step"]
