"""The port's trainer (``pdfnet_tpu_torch.train.trainer``) against the JAX
package's, end to end on the H2O fixture tree of
``tests/test_h2o_dataset.py``.

JAX's ``fit`` runs first: its ``Trainer.init_state`` draws the weights
(seed 317; ``create_train_state`` with its ``model.init`` jitted), which
the port's ``fit`` then starts from (carried across by
``convert.from_flax``; the port's ``init_state`` is wrapped to load them).
Both fit one epoch of 2 steps at batch 1 with ``dropout=0`` and the same
``lr_at_epoch``, evaluate the test split at eval batch 2 (3 records: a
padded tail) after it (``eval_every=1``) and save a checkpoint
(``save_every=1``).  The JAX side runs its Pallas kernels in interpret mode.

- every epoch-mean loss term within 2e-4 relative (the train step's bar,
  ``tests/test_torch_train_step.py``, with BatchNorm frozen as there: live
  statistics of one sample a batch, over a ResNet-50's last stage of 2x2
  positions at this resolution, amplify float32 noise far past any bar);
- every ``MetricAccumulator.result()`` entry within 2e-4 relative, after
  training and, through ``Trainer.evaluate`` alone, at the initial
  weights.

The learning rate is 1e-7.  Adam's first update moves every one of the
88.7M parameters by about ``lr * sign(g)`` whatever the size of ``g``:
coherent over the whole model, so at lr 1e-6 one step already moves the
next batch's loss from 741 to 520 at these random weights.  The ~5,000
entries whose gradient sign float32 noise flips (the FPN's lateral 1x1
kernels and the attention key biases, whose gradient is zero in exact
arithmetic, lead) then move 2 * lr the other way, which at lr 1e-6 puts
the second step's loss 2.2e-4 apart and a projected-landmark metric after
two steps 7e-4 apart (the first step's terms agree within 5e-6); this is
the effect ``tests/test_torch_train_step.py`` bounds with its 1e-3
trajectory bar at lr 1e-4.  At 1e-7 it is ten times smaller, and the
parameters still move (checked).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdfnet_tpu.config import Config as JaxConfig
from pdfnet_tpu.data.h2o import H2ODataset as JaxDataset
from pdfnet_tpu.ops import grouping as jax_grouping
from pdfnet_tpu.train import trainer as jax_trainer
from pdfnet_tpu.train.step import TrainState, make_optimizer

from pdfnet_tpu_torch import convert
from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data.h2o import H2ODataset
from pdfnet_tpu_torch.train import trainer as port_trainer

from test_h2o_dataset import h2o_tree  # noqa: F401  (fixture reuse)
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8,
             batch_size=1, eval_batch_size=2, dropout=0.0, num_epochs=1,
             num_devices=1, num_workers=1, freeze_bn_stats=True, lr=1e-7)
REL = 2e-4


def _recording(cls, name, log, keep=lambda out: out):
    """Wrap ``cls.name`` to append (self, keep(result)) of each call to
    log."""
    orig = getattr(cls, name)

    def run(self, *a, **k):
        out = orig(self, *a, **k)
        log.append((self, keep(out)))
        return out
    return run


def jitted_create_train_state(cfg, model, rng, sample_batch):
    """JAX's ``create_train_state`` (``step.py:46-60``) with ``model.init``
    under ``jax.jit``: run eagerly, the init dispatches and compiles each of
    its ~1,000 primitives on its own (~100 s of this test on the CPU)."""
    p_rng, d_rng = jax.random.split(rng)
    variables = jax.jit(lambda p, d, b: model.init(
        {"params": p, "dropout": d}, b["input"], b["choose"], b["cloud"],
        b["depth"], b["ind"], b["K_new"], b["valid"], train=False))(
        p_rng, d_rng, sample_batch)
    return TrainState(params=variables["params"],
                      batch_stats=variables.get("batch_stats", {}),
                      opt_state=make_optimizer(cfg).init(variables["params"]),
                      step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def runs(h2o_tree, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    kw = dict(cache_path=h2o_tree, pre_fix=h2o_tree, **SMALL)
    out = {}
    try:
        mp.setattr(jax_grouping, "_FUSED_INTERPRET", True)
        mp.setattr(jax_trainer, "create_train_state",
                   jitted_create_train_state)
        jlog = {n: [] for n in ("init_state", "run_epoch", "evaluate")}
        # the initial weights as host copies: the train step donates them
        host = lambda st: {"params": jax_tree_to_numpy(st.params),
                           "batch_stats": jax_tree_to_numpy(st.batch_stats)}
        for n in jlog:
            mp.setattr(jax_trainer.Trainer, n, _recording(
                jax_trainer.Trainer, n, jlog[n],
                host if n == "init_state" else (lambda out: out)))
        jdir = tmp_path_factory.mktemp("jax_fit")
        jcfg = JaxConfig(**kw)
        jax_trainer.fit(jcfg, JaxDataset(jcfg, "train"),
                        JaxDataset(jcfg, "test"), log_dir=str(jdir / "logs"),
                        ckpt_dir=str(jdir / "ckpt"), eval_every=1,
                        save_every=1, max_steps_per_epoch=2)
        variables = jlog["init_state"][0][1]

        plog = {n: [] for n in ("run_epoch", "evaluate")}
        for n in plog:
            mp.setattr(port_trainer.Trainer, n,
                       _recording(port_trainer.Trainer, n, plog[n]))
        orig_init = port_trainer.Trainer.init_state

        def init_from_jax(self, *a, **k):
            state = orig_init(self, *a, **k)
            self.model.load_state_dict(convert.from_flax(variables,
                                                         self.model))
            return state
        mp.setattr(port_trainer.Trainer, "init_state", init_from_jax)
        pdir = tmp_path_factory.mktemp("port_fit")
        pcfg = Config(**kw)
        trainer = port_trainer.fit(
            pcfg, H2ODataset(pcfg, "train"), H2ODataset(pcfg, "test"),
            log_dir=str(pdir / "logs"), ckpt_dir=str(pdir / "ckpt"),
            eval_every=1, save_every=1, max_steps_per_epoch=2, device="cpu")
        moved = sum(not np.array_equal(p.detach().numpy(), w)
                    for (n, p), w in zip(trainer.model.named_parameters(),
                                         _leaves(variables, trainer.model)))

        # Trainer.evaluate alone at the initial weights, both packages
        jt = jlog["run_epoch"][0][0]
        jt.state = jt.state.replace(**variables)
        ja = jt.evaluate(JaxDataset(jcfg, "test").batches(2, 0))
        trainer.model.load_state_dict(convert.from_flax(variables,
                                                        trainer.model))
        pa = trainer.evaluate(H2ODataset(pcfg, "test").batches(2, 0))
        out.update(jax_means=jlog["run_epoch"][0][1], moved=moved,
                   port_means=plog["run_epoch"][0][1],
                   jax_eval=jlog["evaluate"][0][1].result(),
                   port_eval=plog["evaluate"][0][1].result(),
                   jax_eval0=ja.result(), port_eval0=pa.result(),
                   pdir=pdir, counts=(ja.count, pa.count))
    finally:
        mp.undo()
    return out


def _leaves(variables, model):
    """The JAX variables as the port's parameters, in their order."""
    sd = convert.from_flax(variables, model)
    return [sd[n].numpy() for n, _ in model.named_parameters()]


def jax_tree_to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        assert abs(got[k] - w) <= REL * max(abs(w), 1e-3), (what, k, got[k],
                                                          w)


def test_fit_and_evaluate_match_jax(runs):
    """One test over the module's fixture: the driver's workers each run a
    module fixture for the tests they get, and this one costs a JAX compile
    of the train and eval steps."""
    assert runs["moved"] > 100
    want = {k: v for k, v in runs["jax_means"].items()
            if not k.endswith("_avg_s")}
    got = {k: v for k, v in runs["port_means"].items()
           if not k.endswith("_avg_s")}
    assert want["loss"] > 0
    _close(got, want, "epoch means")
    _close(runs["port_eval"], runs["jax_eval"], "eval after fit")
    assert runs["counts"] == (3, 3)            # pad rows do not count
    _close(runs["port_eval0"], runs["jax_eval0"], "eval at init")

    pdir = runs["pdir"]
    with open(os.path.join(pdir, "logs", "H2O-val.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "eval " and len(lines) == 9
    assert os.path.exists(os.path.join(pdir, "ckpt", "model_0"))
    assert os.path.exists(os.path.join(pdir, "logs", "log.jsonl"))
