"""The port's checkpoints (``pdfnet_tpu_torch.train.checkpoint``, torch's
format where the JAX package uses orbax): a save and a load restore the
parameters, the BatchNorm statistics, the Adam moments and step counts, the
train step count and the epoch bit for bit, so that the next update after
a restore is the update the saved state would have made; tolerant partial
restore (skipped entries keep their values, an incompatible optimizer state
is reinitialised), retention (as ``tests/test_train.py:140``), the latest
checkpoint, the subtree save and ``load_variables``.
"""

import os

import pytest
import torch

import pdfnet_tpu_torch as port
from pdfnet_tpu_torch.train import checkpoint as ckpt_lib
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(default_resolution=64, compute_dtype="float32", sample_num=256,
             sample_num_level1=128, sample_num_level2=128, knn_k=8,
             dropout=0.0)


def _state(seed=0):
    cfg = port.Config(**SMALL, seed=seed)
    model = port.build_model(cfg, device="cpu")
    return cfg, port.create_train_state(cfg, model)


@pytest.fixture(scope="module")
def trained():
    """A state after one train step (live BatchNorm: the statistics move)
    and the batch of the next step."""
    cfg, state = _state()
    consts = port.load_loss_consts("cpu")
    step = port.make_train_step(cfg, state.model, consts)
    step(state, port.make_batch(cfg, 2, seed=0), 30, 1e-3)
    return cfg, state, consts, port.make_batch(cfg, 2, seed=1)


class _Tiny(torch.nn.Module):
    """A stand-in with the checkpoint's kinds of tensors (parameters under
    three top-level modules, BatchNorm statistics) for the tests of the file
    format, where HandNet's 400 MB of weights and moments would only cost
    time."""

    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.encoder = torch.nn.Linear(4, 8)
        self.mid = torch.nn.BatchNorm1d(8)
        self.decoder = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.decoder(self.mid(self.encoder(x)))


def _tiny(seed=0, steps=1):
    model = _Tiny(seed)
    state = port.TrainState(model=model, optimizer=torch.optim.Adam(
        model.parameters(), lr=1e-3))
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        state.optimizer.zero_grad()
        model(torch.randn(6, 4, generator=gen)).square().sum().backward()
        state.optimizer.step()
        state.step += 1
    return state


def _snapshot(state):
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    stats = {n: b.clone() for n, b in state.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    opt = {i: {k: v.clone() for k, v in s.items()}
           for i, s in enumerate(state.optimizer.state.values())}
    return params, stats, opt


def _equal(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


def test_round_trip_is_bit_exact_and_resumes_the_update(trained, tmp_path):
    cfg, state, consts, nxt = trained
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, epoch=7)
    assert os.path.basename(path) == "model_7"
    before = _snapshot(state)

    _, fresh = _state(seed=5)               # other weights, no Adam state
    fresh, epoch = ckpt_lib.load_checkpoint(path, fresh)
    assert epoch == 7 and fresh.step == state.step == 1
    _equal(_snapshot(fresh), before)
    assert all(float(s["step"]) == 1.0
               for s in fresh.optimizer.state.values())

    # the next update from the restored state is the saved state's
    for st in (state, fresh):
        port.make_train_step(cfg, st.model, consts)(st, nxt, 30, 1e-3)
    _equal(_snapshot(fresh), _snapshot(state))


def test_tolerant_partial_restore(tmp_path, capsys):
    state = _tiny()
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, epoch=0)
    payload = torch.load(path, weights_only=True)
    names = list(payload["params"])
    dropped, reshaped = names[0], names[1]
    del payload["params"][dropped]
    payload["params"][reshaped] = torch.zeros(3, 3)
    torch.save(payload, path)

    fresh = _tiny(seed=5, steps=0)
    init = {n: p.detach().clone() for n, p in fresh.model.named_parameters()}
    ckpt_lib.load_checkpoint(path, fresh, resume_optimizer=False)
    got = dict(fresh.model.named_parameters())
    for n in names:
        want = init[n] if n in (dropped, reshaped) else payload["params"][n]
        assert torch.equal(got[n].detach(), want), n
    out = capsys.readouterr().out
    assert f"missing {dropped}" in out and f"skip {reshaped}" in out
    assert not fresh.optimizer.state            # not resumed


def test_incompatible_optimizer_state_is_reinitialised(tmp_path, capsys):
    state = _tiny()
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, epoch=0)
    payload = torch.load(path, weights_only=True)
    first = next(iter(payload["opt_state"]["state"].values()))
    first["exp_avg"] = torch.zeros(2, 2)
    torch.save(payload, path)
    fresh = _tiny(seed=5, steps=0)
    fresh, _ = ckpt_lib.load_checkpoint(path, fresh)
    assert "optimizer state incompatible" in capsys.readouterr().out
    assert not fresh.optimizer.state and fresh.step == 0


def test_retention_and_latest(tmp_path):
    state = _tiny()
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) is None
    for ep in range(5):
        ckpt_lib.save_checkpoint(str(tmp_path), state, ep, keep=3)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("model_"))
    assert left == ["model_2", "model_3", "model_4"]
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == str(tmp_path /
                                                             "model_4")


def test_subtree_checkpoint_and_load_variables(tmp_path):
    state = _tiny()
    path = ckpt_lib.save_subtree_checkpoint(str(tmp_path), state, 3)
    assert os.path.basename(path) == "decoder_3"
    payload = torch.load(path, weights_only=True)
    assert payload["epoch"] == 3 and payload["params"]
    assert all(n.startswith("decoder.") for n in payload["params"])
    with pytest.raises(KeyError, match="no top-level module"):
        ckpt_lib.save_subtree_checkpoint(str(tmp_path), state, 3, "trunk")

    full = ckpt_lib.save_checkpoint(str(tmp_path), state, 3)
    fresh = _tiny(seed=5, steps=0)
    ckpt_lib.load_variables(full, fresh.model)
    _equal(_snapshot(fresh)[0], _snapshot(state)[0])
    _equal(_snapshot(fresh)[1], _snapshot(state)[1])
    # a decoder-only checkpoint overlays the decoder and keeps the rest
    other = _tiny(seed=6, steps=0)
    keep = {n: p.detach().clone() for n, p in other.model.named_parameters()}
    ckpt_lib.load_variables(path, other.model)
    for n, p in other.model.named_parameters():
        want = payload["params"][n] if n.startswith("decoder.") else keep[n]
        assert torch.equal(p.detach(), want), n
