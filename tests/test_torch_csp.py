"""The CSP alternate detector of the port (``models/csp.py``,
``train/mano_branch.py``'s ``csp_loss``, the CSP train step, the trainer
and the CLI) against the JAX package, at res 64 and batch 2.

Every flax leaf is drawn with numpy (``_random_like``) and carried across by
``convert.from_flax``; gradients cross by ``convert.params_from_flax``.
Tolerances:

- ``csp_18``, one train step (train-mode forward with live BatchNorm,
  ``csp_loss``, backward, Adam): the heads and all three thetas within 1e-4
  of each output's magnitude, every loss term within 1e-5 relative, every
  gradient leaf within 1e-2 of its norm (the train step's bar,
  ``tests/test_torch_train_step.py``), the running statistics within 1e-5
  (``feat_bn`` at flax momentum 0.99); each parameter's Adam move within
  2 * lr of JAX's (a first Adam step moves a parameter by about
  lr * sign(g), and a gradient entry at float32 noise may flip its sign);
- ``csp_50`` (eval mode) and ``csp_18`` with the uv prior (train mode,
  ``iterations=1``): the forward within 1e-4 of each output's magnitude.
  A train-mode ``csp_50`` forward at these random weights drifts by 2e-4
  between two float32 evaluation orders (live BatchNorm through sixteen
  bottlenecks amplifies the last bits), so it is compared in eval mode;
- bf16: the port's outputs within 4 bf16 steps and its loss terms within
  1e-2 of JAX's bf16 model (eval mode), and every output's dtype flax's;
- ``replicate_reference_quirks``: ``csp_loss`` (the origforward
  composition) term by term within 1e-5 on fixed numpy thetas and
  heatmaps, with its gradients, at epochs 0 and 25 on H2O and RHD; on H2O
  the reprojection term, the total and the gradient within 1e-4, as that
  dataset projects the untranslated hands (joints around z = 0), where
  1/z amplifies the last bits of z (the two packages differ there by
  4.9e-5 on this data, every other term by less than 2e-7).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.models import resnet as jax_resnet
from pdfnet_tpu.models.csp import CSPNet as JaxCSPNet
from pdfnet_tpu.models.csp import build_csp_model as jax_build_csp_model
from pdfnet_tpu.train.mano_branch import csp_loss as jax_csp_loss
from pdfnet_tpu.train.step import make_optimizer

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.models import resnet
from pdfnet_tpu_torch.models.csp import CSPNet, build_csp_model
from pdfnet_tpu_torch.models.layers import BatchNorm
from pdfnet_tpu_torch.train.mano_branch import csp_loss, load_mano_branch_consts
from pdfnet_tpu_torch.train.step import (create_train_state,
                                         make_csp_train_step)

from test_torch_eval_step import _random_like
from test_torch_mano_branch import jax_mano_branch_consts
from test_torch_train_step import jit_update
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(default_resolution=64, compute_dtype="float32", batch_size=2,
             sample_num=256, sample_num_level1=128, sample_num_level2=128,
             knn_k=8)
B, G = 2, 16                       # batch, the /4 grid of res 64
OUT_TOL = 1e-4
LOSS_RTOL = 1e-5
PROJ_RTOL = 1e-4
GRAD_RTOL = 1e-2
BF16_TOL = 1e-2
BF16_STEPS = 4
BN_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-4
# the Adam move is held to 1e-3 of lr where JAX's gradient exceeds 1e-3 of
# its leaf's largest entry
ADAM_RTOL = 1e-3
ADAM_GRAD_FLOOR = 1e-3


def _batch(seed=0):
    return port.make_batch(port.Config(**SMALL), B, seed=seed)


def _variables(module, img, depth, seed=1):
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, img[:1], depth[:1], True))
    rng = np.random.RandomState(seed)
    return {c: _random_like(shapes[c], rng) for c in ("params", "batch_stats")}


def _assert_out_close(got, want, what):
    """max |got - want| within OUT_TOL of max |want|."""
    got = got.detach().float().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= OUT_TOL, f"{what}: {err:.3e} of its magnitude"


def _assert_running_stats(bs_j, model):
    checked = 0
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            ref = bs_j
            for part in name.split("."):
                ref = ref[part]
            np.testing.assert_allclose(m.running_mean.numpy(),
                                       np.asarray(ref["mean"]), **BN_TOL,
                                       err_msg=name)
            np.testing.assert_allclose(m.running_var.numpy(),
                                       np.asarray(ref["var"]), **BN_TOL,
                                       err_msg=name)
            checked += 1
    return checked


def test_csp18_train_step_matches_jax():
    """One train step of ``csp_18``: outputs, loss terms, gradients, the
    running statistics and the Adam update.  One test, so that one
    process makes the JAX reference (one compile of the gradient)."""
    cfg_j, cfg_t = (JaxConfig(arch="csp_18", **SMALL),
                    port.Config(arch="csp_18", **SMALL))
    batch = _batch()
    model_j = jax_build_csp_model(cfg_j)
    variables = _variables(model_j, batch["input"], batch["depth"])
    consts_j = jax_mano_branch_consts()
    tx = make_optimizer(cfg_j)

    def loss_fn(params, b):
        ret, mutated = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            b["input"], b["depth"], True, mutable=["batch_stats"])
        loss, stats = jax_csp_loss(cfg_j, consts_j, ret, b, 0)
        return loss, (stats, ret, mutated["batch_stats"])

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (stats_j, ret_j, bs_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"], jb)
    opt = jax.jit(tx.init)(variables["params"])
    opt.hyperparams["learning_rate"] = jnp.asarray(LR, jnp.float32)
    params_j, _ = jit_update(tx)(grads_j, opt, variables["params"])

    model = CSPNet(cfg_t.heads, arch="csp_18")
    model.load_state_dict(convert.from_flax(variables, model))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    outs = []
    model.register_forward_hook(lambda m, i, o: outs.append(o))
    state = create_train_state(cfg_t, model)
    stats = make_csp_train_step(cfg_t, model, load_mano_branch_consts("cpu"))(
        state, batch, 0, LR)
    assert state.step == 1 and model.training
    ret = outs[0]

    for h in ("hm", "wh"):
        _assert_out_close(ret[h], ret_j[h], h)
    assert len(ret["params"]) == len(ret_j["params"]) == 3
    for i, (a, b) in enumerate(zip(ret["params"], ret_j["params"])):
        _assert_out_close(a, b, f"theta {i}")
    assert sorted(stats) == sorted(stats_j)
    for k in stats_j:
        np.testing.assert_allclose(float(stats[k]), float(stats_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)

    grads = convert.params_from_flax(jax.tree.map(np.asarray, grads_j), model)
    moved = convert.params_from_flax(jax.tree.map(np.asarray, params_j), model)
    n_held = n_moved = n_all = 0
    for n, p in model.named_parameters():
        want = grads[n].double()
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).double()
        err = float((got - want).norm()) / max(float(want.norm()), 1e-30)
        assert err <= GRAD_RTOL, f"gradient of {n}: {err:.3e} of its norm"
        # Adam's first move is lr * g / (|g| + eps): held where JAX's
        # gradient stands well above float32 noise, and there to the
        # parameters JAX's update wrote (its sign and size), up to the
        # rounding of the sum
        held = (want.abs() > ADAM_GRAD_FLOOR * float(want.abs().max())) & (
            want.abs() > 1e-5)
        step_t = p.detach() - before[n]
        step_j = moved[n] - before[n]
        assert bool((torch.sign(step_t[held]) == torch.sign(step_j[held])
                     ).all()), f"Adam move of {n} has the wrong sign"
        ulp = torch.from_numpy(np.spacing(np.abs(before[n].numpy())))
        diff = (p.detach() - moved[n]).abs()
        assert bool((diff[held] <= ADAM_RTOL * LR + 2 * ulp[held]).all()), (
            f"Adam move of {n}: {float(diff[held].max()):.3e}")
        n_held += int(held.sum())
        n_moved += int((step_t.abs() > LR / 2).sum())
        n_all += p.numel()
    assert n_held > n_all / 2 and n_moved > n_all / 2, (n_held, n_moved, n_all)
    assert _assert_running_stats(bs_j, model) == len(
        [m for m in model.modules() if isinstance(m, BatchNorm)])
    assert model.feat_bn.flax_momentum == 0.99


@pytest.mark.parametrize("arch,uv,train", [("csp_50", False, False),
                                           ("csp_18", True, True)])
def test_csp_forward_matches_jax(arch, uv, train):
    """``csp_50`` at eval, and ``csp_18`` with the uv prior
    (``use_heatmaps``, ``iterations=1``) in train mode with its running
    statistics: the uv prior (B, 32, 32, 21) and the heads."""
    heads = {"hm": 2, "wh": 2, "params": 122}
    rng = np.random.RandomState(5)
    img = rng.randn(B, 64, 64, 3).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, (B, 64, 64)).astype(np.float32)
    iters = 1 if uv else 3
    model_j = JaxCSPNet(heads=heads, arch=arch, use_heatmaps=uv,
                        iterations=iters)
    variables = _variables(model_j, img, depth)
    ret_j, mutated = jax.jit(lambda v, x, d: model_j.apply(
        v, x, d, train, mutable=["batch_stats"]))(variables, img, depth)

    model = CSPNet(heads, arch=arch, use_heatmaps=uv, iterations=iters)
    model.load_state_dict(convert.from_flax(variables, model))
    with torch.no_grad():
        ret = model.train(train)(torch.from_numpy(img),
                                 torch.from_numpy(depth))
    assert sorted(ret) == sorted(ret_j)
    if uv:
        assert ret["uv_prior"].shape == (B, 32, 32, 21)
        _assert_out_close(ret["uv_prior"], ret_j["uv_prior"], "uv_prior")
        _assert_running_stats(mutated["batch_stats"], model)
    for h in ("hm", "wh"):
        _assert_out_close(ret[h], ret_j[h], h)
    assert len(ret["params"]) == iters
    for i, (a, b) in enumerate(zip(ret["params"], ret_j["params"])):
        _assert_out_close(a, b, f"theta {i}")


@pytest.mark.parametrize("epoch,dataset", [(0, "H2O"), (25, "H2O"),
                                           (0, "RHD"), (25, "RHD")])
def test_quirks_loss_matches_jax(epoch, dataset):
    """``replicate_reference_quirks``: ``csp_loss`` is the origforward
    composition (the hm term times 0, translation-less MANO, the epoch-20
    gate on the H2O vertex term, RHD's root-aligned projection); each term
    and the gradients with respect to the last theta map and the heatmap
    logits, on fixed numpy values."""
    kw = dict(SMALL, arch="csp_18", dataset=dataset,
              replicate_reference_quirks=True)
    cfg_j, cfg_t = JaxConfig(**kw), port.Config(**kw)
    batch = _batch(seed=2)
    rng = np.random.RandomState(7)
    hm = rng.randn(B, G, G, 2).astype(np.float32)
    thetas = [(rng.randn(B, G, G, 122) * 0.3).astype(np.float32)
              for _ in range(3)]
    consts_j = jax_mano_branch_consts()

    def loss_j(theta, hm_, b):
        return jax_csp_loss(cfg_j, consts_j,
                            {"hm": hm_, "params": [*thetas[:2], theta]}, b,
                            jnp.asarray(epoch))

    (total_j, stats_j), (g_theta_j, g_hm_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(
        jnp.asarray(thetas[2]), jnp.asarray(hm),
        {k: jnp.asarray(v) for k, v in batch.items()})

    theta = torch.from_numpy(thetas[2]).requires_grad_()
    hm_t = torch.from_numpy(hm).requires_grad_()
    ret = {"hm": hm_t,
           "params": [torch.from_numpy(t) for t in thetas[:2]] + [theta]}
    total, stats = csp_loss(cfg_t, load_mano_branch_consts("cpu"), ret,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            epoch)
    total.backward()
    assert sorted(stats) == sorted(stats_j)
    assert ("verts_loss" in stats) == (dataset == "H2O")
    # H2O projects the untranslated hands, whose joints sit around z = 0:
    # the float32 rounding of z, which the two packages sum in other
    # orders, reaches the pixel coordinates amplified by 1/z
    ill = {"reproj_loss_all", "loss"} if dataset == "H2O" else set()
    for k in stats_j:
        np.testing.assert_allclose(
            float(stats[k].detach()), float(stats_j[k]),
            rtol=PROJ_RTOL if k in ill else LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(total_j),
                               rtol=PROJ_RTOL if ill else LOSS_RTOL)
    g = np.asarray(g_theta_j)
    err = float(np.abs(theta.grad.numpy() - g).max()) / float(np.abs(g).max())
    assert err <= (PROJ_RTOL if ill else LOSS_RTOL), f"d/dtheta: {err:.3e}"
    # the hm term is multiplied by 0: its gradient is kept, and is 0
    assert not np.asarray(g_hm_j).any() and not hm_t.grad.any()


def test_uv_upsample_is_jax_bilinear_resize():
    """The uv decoder's 2x upsample: ``jax.image.resize(..., "bilinear")``
    (half-pixel centres, edge weights renormalized) equals
    ``F.interpolate(align_corners=False)`` (edge coordinates clamped),
    edges included."""
    x = np.random.RandomState(3).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3),
                                       "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        scale_factor=2, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnet101"])
def test_resnet_trees_load_from_flax(name):
    """The flax tree of each constructor (``jax.eval_shape``, no compile)
    loads into the port's: every leaf used once, every shape equal."""
    module = getattr(jax_resnet, name)()
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                False))
    rng = np.random.RandomState(0)
    variables = {c: _random_like(shapes[c], rng)
                 for c in ("params", "batch_stats")}
    model = getattr(resnet, name)()
    state = convert.from_flax(variables, model)
    model.load_state_dict(state)
    n_leaves = sum(len(jax.tree.leaves(variables[c])) for c in variables)
    assert n_leaves == len([k for k in model.state_dict()
                            if not k.endswith("num_batches_tracked")])
    blocks = {"resnet18": 8, "resnet50": 16, "resnet101": 33}[name]
    assert sum(len(n) for n in model.block_names) == blocks


def test_bf16_step_follows_jax_bf16():
    """``compute_dtype="bfloat16"``: the port's outputs and every
    ``csp_loss`` term against JAX's bf16 model on the same weights and
    batch (``csp_18``, eval mode): hidden activations rounded to bf16 after
    float32 sums in another order land one bf16 step apart, and a head's
    sum of them again, so the outputs are held to BF16_STEPS steps of
    their largest magnitude and the loss terms to BF16_TOL (the watch
    list's bar).  The float32 tests cannot see a cast that differs from
    flax's; this one can."""
    kw = dict(SMALL, arch="csp_18", compute_dtype="bfloat16")
    cfg_j, cfg_t = JaxConfig(**kw), port.Config(**kw)
    batch = _batch()
    model_j = jax_build_csp_model(cfg_j)
    variables = _variables(model_j, batch["input"], batch["depth"])
    consts_j = jax_mano_branch_consts()

    def run(v, b):
        ret = model_j.apply(v, b["input"], b["depth"], False)
        return ret, jax_csp_loss(cfg_j, consts_j, ret, b, 0)[1]

    ret_j, stats_j = jax.jit(run)(variables,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    model = CSPNet(cfg_t.heads, arch="csp_18", dtype=torch.bfloat16)
    model.load_state_dict(convert.from_flax(variables, model))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        ret = model.eval()(tb["input"], tb["depth"])
        _, stats = csp_loss(cfg_t, load_mano_branch_consts("cpu"), ret, tb)
    outs = [("hm", ret["hm"], ret_j["hm"]), ("wh", ret["wh"], ret_j["wh"])]
    outs += [(f"theta {i}", a, b)
             for i, (a, b) in enumerate(zip(ret["params"], ret_j["params"]))]
    for what, got, want in outs:
        want = np.asarray(want.astype(jnp.float32))
        err = float(np.abs(got.float().numpy() - want).max())
        # a bf16 step at the output's largest magnitude (8 bits of mantissa)
        step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert err <= BF16_STEPS * step, (what, err / step)
    assert sorted(stats) == sorted(stats_j)
    for k in stats_j:
        np.testing.assert_allclose(float(stats[k]), float(stats_j[k]),
                                   rtol=BF16_TOL, err_msg=k)


@pytest.mark.parametrize("uv", [False, True])
def test_bf16_dtypes_follow_flax(uv):
    """Under ``compute_dtype="bfloat16"`` the outputs have the flax
    module's dtypes (``jax.eval_shape``): the heads bf16, every theta
    float32 (float32 ``feat_bn`` output plus bf16 head output), the uv
    prior bf16; ``feat_bn`` and the ``ConvBNBlock`` norms give float32."""
    heads = {"hm": 2, "wh": 2, "params": 122}
    img = np.zeros((1, 32, 32, 3), np.float32)
    depth = np.zeros((1, 32, 32), np.float32)
    model_j = JaxCSPNet(heads=heads, arch="csp_18", use_heatmaps=uv,
                        iterations=2, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: model_j.init_with_output(
        {"params": jax.random.PRNGKey(0)}, img, depth, True)[0])
    model = CSPNet(heads, arch="csp_18", use_heatmaps=uv, iterations=2,
                   dtype=torch.bfloat16).train()
    norms = {}
    for name in ("feat_bn", "reduce2.bn") if uv else ("feat_bn",):
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: norms.update({name: o.dtype}))
    with torch.no_grad():
        ret = model(torch.from_numpy(img), torch.from_numpy(depth))
    to_torch = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                jnp.dtype(jnp.float32): torch.float32}
    for k, v in shapes.items():
        for a, b in zip(v if isinstance(v, list) else [v],
                        ret[k] if isinstance(v, list) else [ret[k]]):
            assert b.dtype == to_torch[jnp.dtype(a.dtype)], k
            assert tuple(b.shape) == a.shape, k
    assert ret["params"][-1].dtype == torch.float32
    assert set(norms.values()) == {torch.float32}


def _trainer_cfg(**kw):
    return port.Config(arch="csp_18", **{**SMALL, **kw})


def test_trainer_trains_csp_and_refuses_eval():
    """``Trainer`` dispatches on ``arch``: the CSP model, its constants and
    step, no eval step; two steps, ``evaluate`` raising as JAX's does, no
    image summary."""
    from pdfnet_tpu_torch.train.trainer import Trainer
    cfg = _trainer_cfg(image_summary=True)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.is_csp and isinstance(trainer.model, CSPNet)
    assert trainer.eval_step is None
    trainer.init_state()
    batches = [_batch(seed=s) for s in range(2)]
    means = trainer.run_epoch(0, iter(batches))
    assert trainer.state.step == 2
    assert np.isfinite(means["loss"]) and np.isfinite(means["hm_loss"])
    assert trainer.image_summary(batches[0]) is None
    with pytest.raises(NotImplementedError, match="mesh evaluation"):
        trainer.evaluate(iter(batches))


@pytest.mark.parametrize("arch", ["csp_50", "csp_18"])
def test_build_model_refuses_the_csp_archs(arch):
    """As JAX's ``build_model`` does: a ValueError pointing to
    ``build_csp_model``, which builds the detector."""
    cfg = port.Config(**SMALL).replace(arch=arch)
    with pytest.raises(ValueError, match="build_csp_model"):
        port.build_model(cfg, device="cpu")
    model = build_csp_model(cfg, device="cpu")
    assert isinstance(model, CSPNet) and not model.training
    width = {"csp_50": 2048, "csp_18": 512}[arch]
    assert model.p5.weight.shape[0] == width


def test_cli_trains_csp_and_restores_its_checkpoint(tmp_path):
    """``--arch csp_18 --synthetic --steps 2`` trains; its checkpoint
    restores bit for bit into a new trainer."""
    from pdfnet_tpu_torch.cli.main import main
    from pdfnet_tpu_torch.train.trainer import Trainer
    out = str(tmp_path / "out")
    trained = main(["--mode", "train", "--arch", "csp_18", "--synthetic",
                    "--cpu", "--steps", "2", "--num_epochs", "1",
                    "--save_every", "1", "--output_path", out,
                    "--default_resolution", "64", "--compute_dtype",
                    "float32", "--batch_size", "2"])
    assert trained.state.step == 2
    ckpt = os.path.join(out, "ckpt", "default", "model_0")
    restored = Trainer(_trainer_cfg(), device="cpu")
    restored.init_state(seed=5)
    assert restored.load(ckpt) == 0 and restored.state.step == 2
    for a, b in ((trained.model.state_dict(), restored.model.state_dict()),):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    opt_a = trained.state.optimizer.state_dict()["state"]
    opt_b = restored.state.optimizer.state_dict()["state"]
    assert sorted(opt_a) == sorted(opt_b)
    for i in opt_a:
        for k in opt_a[i]:
            assert torch.equal(opt_a[i][k], opt_b[i][k]), (i, k)
