"""The port's ``MetricAccumulator`` against the JAX package's, on
``tests/test_metrics_parity.py``'s fake eval stream: equal ``result()``
values, the same ``H2O-val.txt`` block text and the same ``hand_poses.json``
bytes, fed one sample at a time and in batches whose padded tail rows
(``pad_mask`` 0) carry other values that must not count.
"""

import numpy as np
import pytest

from pdfnet_tpu.train.metrics import MetricAccumulator as JaxAccumulator

from pdfnet_tpu_torch.train.metrics import MetricAccumulator

from test_metrics_parity import _fake_eval_stream
from test_torch_threads import one_torch_thread  # noqa: F401


def _batched(stream, bs):
    """The stream in batches of ``bs``, the tail padded with a copy of the
    first sample scaled away (as wrong as a real pad row may be) and its
    ``pad_mask`` zero."""
    out = []
    for i in range(0, len(stream), bs):
        part = stream[i:i + bs]
        pad = bs - len(part)
        part = part + [({k: v * 3.0 + 1.0 for k, v in stream[0][0].items()},
                        stream[0][1])] * pad
        o = {k: np.concatenate([p[0][k] for p in part]) for k in part[0][0]}
        b = {k: np.concatenate([p[1][k] for p in part]) for k in part[0][1]}
        b["pad_mask"] = np.array([1.0] * (bs - pad) + [0.0] * pad, np.float32)
        out.append((o, b))
    return out


def _run(cls, feed):
    acc = cls()
    for out, batch in feed:
        acc.update(out, batch)
    return acc


@pytest.mark.parametrize("bs", [1, 3, 4])
def test_metric_accumulator_equals_jax(bs, tmp_path):
    stream = _fake_eval_stream(n=7)
    feed = stream if bs == 1 else _batched(stream, bs)
    got, want = _run(MetricAccumulator, feed), _run(JaxAccumulator, feed)
    assert got.count == want.count == 7
    assert got.result() == want.result()
    assert got.format_block("x") == want.format_block("x")
    got.write_h2o_submission(str(tmp_path / "port.json"))
    want.write_h2o_submission(str(tmp_path / "jax.json"))
    port_bytes = (tmp_path / "port.json").read_bytes()
    assert port_bytes == (tmp_path / "jax.json").read_bytes()
    # one row a real sample, 126 floats each (two hands of 21 joints)
    import json
    sub = json.loads(port_bytes)
    assert sub["modality"] == "RGBD"
    assert sum(len(v) for k, v in sub.items() if k != "modality") == 7


def test_batched_equals_one_at_a_time():
    stream = _fake_eval_stream(n=7, seed=1)
    one = _run(MetricAccumulator, stream)
    four = _run(MetricAccumulator, _batched(stream, 4))
    # float32 per-sample means, reduced in another order over a batch
    for k, v in one.result().items():
        assert four.result()[k] == pytest.approx(v, rel=1e-6)
    assert one.format_block() == four.format_block()


def test_all_reduce_is_the_identity_in_one_process():
    acc = _run(MetricAccumulator, _fake_eval_stream(n=3))
    before = acc.result()
    assert acc.all_reduce() is acc and acc.result() == before


def test_all_reduce_merges_the_ranks_rows(monkeypatch):
    """With more than one rank (once refused) the merge sums the sums and
    counts in rank order and unions the submission rows, as the JAX merge
    does: here the ranks' partial accumulators are handed over by a
    stand-in for the collective (``tests/test_torch_parallel.py`` runs the
    real one over gloo)."""
    import torch.distributed as dist
    stream = _fake_eval_stream(n=7)
    parts = [_run(MetricAccumulator, stream[r::2]) for r in (0, 1)]

    def all_gather_object(out, obj):
        for r, acc in enumerate(parts):
            out[r] = ([acc.sums[k] for k in acc.KEYS] + [acc.count],
                      acc._action_lists)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    merged = parts[0].all_reduce()
    one = _run(JaxAccumulator, stream)
    assert merged.count == one.count == 7
    for k, v in one.result().items():
        assert merged.result()[k] == pytest.approx(v, rel=1e-12)
    assert merged._action_lists == one._action_lists
