"""True float32: every float32 step of the port runs each convolution with
both TF32 flags off (``torch.backends.cudnn.allow_tf32``, whose default is
True, and ``torch.backends.cuda.matmul.allow_tf32``), the train steps'
backward passes too, and gives the caller's flags back afterwards.

The flags are read by hooks on every ``Conv2d`` at a small shape on the CPU:
the same Python runs on the card, where cuDNN reads them.
"""

import pytest
import torch

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch.bench import random_batch
from pdfnet_tpu_torch.models.csp import build_csp_model
from pdfnet_tpu_torch.train.mano_branch import load_mano_branch_consts
from pdfnet_tpu_torch.train.step import make_csp_train_step
from pdfnet_tpu_torch.utils.precision import float32_precision

from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8,
             batch_size=2)


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _record(model, backward: bool):
    """Hooks on every Conv2d of ``model`` appending the TF32 flags seen by
    its forward (and backward) to the returned list."""
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(lambda *_: seen.append(("fwd", _flags())))
            if backward:
                m.register_full_backward_hook(
                    lambda *_: seen.append(("bwd", _flags())))
    return seen


def _eval(cfg):
    model = port.build_model(cfg, device="cpu")
    step = port.make_eval_step(cfg, model, port.load_loss_consts("cpu"))
    return model, lambda: step(random_batch(2, 64, 256))


def _train(cfg):
    model = port.build_model(cfg, device="cpu")
    state = port.create_train_state(cfg, model)
    step = port.make_train_step(cfg, model, port.load_loss_consts("cpu"))
    batch = port.make_batch(cfg, 2, seed=0)
    return model, lambda: step(state, batch, 0, 1e-7)


def _csp_train(cfg):
    cfg = cfg.replace(arch="csp_18")
    model = build_csp_model(cfg, device="cpu")
    state = port.create_train_state(cfg, model)
    step = make_csp_train_step(cfg, model, load_mano_branch_consts("cpu"))
    batch = port.make_batch(cfg, 2, seed=0)
    return model, lambda: step(state, batch, 0, 1e-7)


def _infer(cfg):
    cfg = cfg.replace(knn_method="pallas", fused_trunk=True)
    model = port.build_model(cfg, device="cpu")
    b = random_batch(2, 64, 256)
    return model, lambda: port.infer_rgbd(
        model, b["input"], b["depth"], b["K_new"], b["valid"],
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("make,backward", [(_eval, False), (_train, True),
                                           (_csp_train, True),
                                           (_infer, False)],
                         ids=["eval_step", "train_step", "csp_train_step",
                              "infer_rgbd"])
def test_float32_steps_run_every_conv_without_tf32(make, backward):
    model, run = make(port.Config(**SMALL))
    seen = _record(model, backward)
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True       # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        run()
        assert _flags() == (True, True), "the caller's flags not restored"
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    kinds = {k for k, _ in seen}
    assert kinds == ({"fwd", "bwd"} if backward else {"fwd"}), kinds
    assert all(f == (False, False) for _, f in seen), \
        [f for f in seen if f[1] != (False, False)][:3]


def test_precision_context_restores_on_error_and_skips_bf16():
    saved = _flags()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError):
            with float32_precision("float32"):
                assert _flags() == (False, False)
                raise RuntimeError("inside")
        assert _flags() == (True, True)
        with float32_precision("bfloat16"):
            assert _flags() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
