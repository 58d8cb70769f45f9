"""The port's set abstraction past the limits of its first kernels: clouds
wider than the 1024 points a lane keeps in registers, and more neighbours
than the 64 rows ``sa_mlp_max`` takes at a time.

The plain versions (which ``chip_smoke.py`` holds the CUDA kernels to, bit
for bit or within its MLP tolerance, at these widths on the card) against
the TPU kernels in interpret mode at N = 2048 and k = 128, as
``tests/test_torch_sa.py`` compares them at the main path's widths; the
shapes past the block's shared memory, which the selection takes by
spilling to device memory; and the one limit that remains (k above a
level's points), refused by name when the model is built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdfnet_tpu.ops.pallas_knn import (knn_pallas, sa_level1_pallas,
                                       sa_level2_pallas)

from pdfnet_tpu_torch import build_model
from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.models.handnet import check_config
from pdfnet_tpu_torch.ops import sa
from test_torch_threads import one_torch_thread  # noqa: F401

H, N, S, K = 2, 2048, 128, 128
R1, R2 = 0.015, 0.04
TOL = dict(atol=1e-5, rtol=1e-5)


def _folded(widths, cin, seed):
    rng = np.random.RandomState(seed)
    out = []
    for f in widths:
        out.append((rng.randn(cin, f).astype(np.float32) / np.sqrt(cin),
                    rng.uniform(-0.3, 0.3, f).astype(np.float32)))
        cin = f
    return out


def _torch(folded):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in folded]


def test_knn_selection_matches_pallas_wide_with_ties():
    """N = 2048 on a 1/32 grid (exact distances, so exact ties at the k-th
    place), k = 128: the same indices and distances."""
    pts = (np.random.RandomState(0).randint(-4, 5, (H, N, 3))
           / 32.0).astype(np.float32)
    dist_j, idx_j = knn_pallas(jnp.asarray(pts[:, :S]), jnp.asarray(pts),
                               k=K, interpret=True)
    dist_t, idx_t = sa.knn_plain(torch.from_numpy(pts), S, K)
    d = np.asarray(dist_j)
    assert (d[..., 1:] == d[..., :-1]).any(), "no ties planted"
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(dist_t.numpy(), d)


def test_sa_level1_matches_pallas_wide():
    pts = np.random.RandomState(1).uniform(-0.1, 0.1, (H, N, 3)
                                           ).astype(np.float32)
    folded = _folded(sa.MLP_WIDTHS[0], 3, 2)
    ref = sa_level1_pallas(jnp.asarray(pts), folded, k=K, num_centers=S,
                           radius2=R1, interpret=True)
    got = sa.sa_level1(torch.from_numpy(pts), _torch(folded), K, S, R1,
                       torch.float32)
    assert got.shape == (H, S, sa.MLP_WIDTHS[0][-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_sa_level2_matches_pallas_wide():
    rng = np.random.RandomState(3)
    feat = np.concatenate([rng.uniform(-0.1, 0.1, (H, N, 3)),
                           rng.randn(H, N, 128)], -1).astype(np.float32)
    folded = _folded(sa.MLP_WIDTHS[1], 131, 4)
    ref = sa_level2_pallas(jnp.asarray(feat), folded, k=K, num_centers=S,
                           radius2=R2, interpret=True)
    got = sa.sa_level2(torch.from_numpy(feat), _torch(folded), K, S, R2,
                       torch.float32)
    assert got.shape == (H, S, sa.MLP_WIDTHS[1][-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n,k", [(1024, 1024), (2048, 2048), (4096, 64),
                                 (4096, 2864), (3058, 3058)])
def test_selection_limit_takes(n, k):
    """The shapes the selection kernel takes in shared memory: k = N up to
    3058, N = 4096 up to k = 2864 (within MAX_SMEM; nothing spills)."""
    sa.check_selection_shape("knn", n, min(512, n), k)
    assert sa.selection_smem_bytes(n, k) <= sa.MAX_SMEM
    assert sa.selection_spill(n, k) == 0


@pytest.mark.parametrize("n,k,spill", [(4096, 2865, 1), (3059, 3059, 1),
                                       (20000, 64, 2)])
def test_selection_past_shared_memory_is_taken(n, k, spill):
    """The shapes past the block's shared memory are taken: the candidate
    lists spill to a second half of the workspace, and past 19370 points
    the cloud's xyz is read from device memory."""
    sa.check_selection_shape("knn", n, 512, k)
    assert sa.selection_smem_bytes(n, k) > sa.MAX_SMEM
    assert sa.selection_spill(n, k) == spill
    ws = sa._workspace(2, n, 512, k, "meta")
    assert tuple(ws.shape) == (2, 2, 512, k)


def test_plain_selection_k_equals_n_4096_matches_stable_argsort():
    """k = N = 4096 on one hand (a spilled shape on the card): the plain
    selection every kernel is held to is numpy's stable argsort of the
    exact float32 d2, ties (a 1/32 grid) in index order."""
    pts = (np.random.RandomState(5).randint(-4, 5, (1, 4096, 3))
           / 32.0).astype(np.float32)
    ctr = pts[:, :64]
    diff = pts[:, None] - ctr[:, :, None]
    d2 = ((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
          + diff[..., 2] * diff[..., 2])
    want = np.argsort(d2, axis=-1, kind="stable")
    dist, idx = sa.knn_plain(torch.from_numpy(pts), 64, 4096)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(dist.numpy(),
                                  np.take_along_axis(d2, want, -1))


@pytest.mark.parametrize("field,value", [("sample_num", 2048),
                                         ("sample_num", 4096),
                                         ("knn_k", 128), ("knn_k", 512)])
def test_config_takes_wide_clouds_and_many_neighbours(field, value):
    check_config(Config().replace(**{field: value}))


@pytest.mark.parametrize("kw,name", [
    (dict(knn_k=513), "sample_num_level1"),
    (dict(sample_num_level1=2048), "sample_num=1024")])
def test_build_model_refuses_the_remaining_limits(kw, name):
    """A selection that does not exist (k above N at a level, more centers
    than points) is refused by name when the model is built, never inside
    a step."""
    with pytest.raises(ValueError, match=name):
        build_model(Config().replace(**kw), device="cpu")


def test_build_model_takes_k_equals_n_4096():
    """k = N = 4096 at level 1, past the block's shared memory, builds: the
    selection spills its lists to device memory."""
    cfg = Config().replace(sample_num=4096, sample_num_level1=4096,
                           knn_k=4096)
    assert sa.selection_spill(4096, 4096) == 1
    build_model(cfg, device="cpu")
