#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pdfnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the root of a checkout
    python3 chip_smoke.py --profile   # also profiles the steps (batch 8, 32)

Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA source in ``pdfnet_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. every kernel at the shapes of its path at batch 8 (16 hands), against
   its plain PyTorch version on the same inputs: the grouping kernels bit
   for bit (identical neighbour selection, exact ties planted), the MLP
   and bottleneck kernels within stated tolerances; the five selection
   entry points also on the cases a threshold selection stresses
   (identical points, ties at the k-th place, k = N up to 1024, N not a
   multiple of 32, NaN/inf clusters larger than k, points on the radius,
   k = 8 and 128) and, at 16 hands, on clouds wider than 1024 points
   (N = 1500, 2048, 2050 and 4096, k = 100 and 128, k = N = 2048, ties and
   NaN/inf clusters) and past the block's shared memory (k = N = 4096;
   N = 4096, k = 3000; N = 20000, k = 64; each with and without NaN/inf
   clusters), ``sa_mlp_max`` at k = 128 and 256 (k in chunks of 64); the
   float32 bodies of ``sa_mlp_max`` and ``fused_bottleneck_s1`` beside the
   bf16 ones; kernel, plain and bound times, every kernel timed by
   CUDA-graph replay (and eagerly) beside a yardstick timed the same way
   (d2 by broadcasting and ``torch.topk``, with the gather for the row
   kernels; three cuBLAS matmuls with bias, ReLU and the max; cuDNN on the
   folded weights), which the port never calls; the train grouping ops'
   backward passes on the card against the CPU;
4. the batched RGB-D eval step (``build_model`` + ``make_eval_step``) at the
   full width of the default ``Config`` with seeded random weights and
   jittered BatchNorm statistics, on the bench's batch layout: output shapes
   and finiteness, the kernels' launch counts in one step, the float32 step
   on the card against the same model on the CPU (plain versions) at batch
   1, again with torch's default TF32 flags (the step sets TF32 off
   itself), the float32 step's launch counts, and frames/s in bfloat16 and
   float32 at batch 8 and 32; and one float32 eval step at
   ``sample_num=2048``, ``knn_k=128`` on the card against the CPU;
5. the train step (``create_train_state`` + ``make_train_step``: forward in
   training mode, the loss, backward, Adam) at the full width of the default
   ``Config`` on a synthetic batch of 8 from the port's ``make_batch``: the
   kernels' launch counts in one step, finite losses, parameters and
   BatchNorm statistics moved, samples/s in bfloat16 and float32; and a
   float32 step on the card against the CPU at batch 2 (frozen BatchNorm, no
   dropout): every loss term and every parameter's gradient;
6. the self-contained RGB-D serving step (``infer_rgbd`` + ``eval_outputs``:
   clouds built on the card from the predicted masks and the depth) at the
   full width of the default ``Config`` with ``knn_method="pallas"`` and
   ``fused_trunk=True``, on the bench's random batch: output shapes and
   finiteness, the kernels' launch counts in one step, a float32 step on the
   card against the CPU at batch 1 with deterministic sampling (also with
   torch's default TF32 flags), the float32 step's launch counts, and
   frames/s in bfloat16 and float32 at batch 8 and 32 (and the default
   serving config's bfloat16 rate at batch 8 beside them);
7. the train/eval CLI (``pdfnet_tpu_torch.cli.main``) in process at the
   default ``Config`` on an H2O-format tree it writes under ``chiprun_out/``
   (1280x720 frames, 24 train and 10 test records): ``--mode train`` for 3
   steps with an eval and a checkpoint, then ``--mode test`` from that
   checkpoint: the score files, the kernels' launches per train step and
   eval batch, the checkpoint round trip bit for bit, a float32 test-mode
   evaluation on the card against the CPU, and the train step, data wait
   and eval rate through the loader;
8. the serving CLI (``pdfnet_tpu_torch.cli.infer``) in process at the
   default ``Config`` (bf16, ``pallas_sa``) at batch 8 on 20 color/depth
   pairs at 1280x720 that it writes (the CLI phase's MANO hands) and a
   checkpoint of seeded weights with split masks: names, shapes,
   finiteness, the 126-float JSON, the kernels' launches a batch
   (``sa_group_l1`` 1, ``sa_group_l2`` 1, ``sa_mlp_max`` 2); then the
   steady-state frames/s through the host preprocessing, from 5 runs of
   the CLI on 320 frames (those 20, each copied 16 times: 40 whole
   batches), each run's rate and their spread;
9. the demo CLI (``pdfnet_tpu_torch.cli.demo``) on 2 of those frames at
   384x384: its three JPGs a frame and the launches a frame; then
   ``render_two_hands`` of the drawn hands on the card against the CPU
   (the mask differs on at most 0.1 % of the pixels, depth and rgb within
   1e-4 where both hit) and its ms a call;
10. ``python -m pdfnet_tpu_torch.bench`` at ``bench.py``'s defaults in its
   three modes (eval; ``--self_contained --knn pallas --fused_trunk``;
   ``--train``), each a subprocess: exit 0, one JSON line with the mode's
   metric and a positive value, which the script prints, and the mode's
   kernels launched once a timed call;
11. (run after phase 6; its CLI part inside phase 7, on that tree)
   ``Config(sample_strategy="FPS", input_feature_num=6)`` at full width:
   the serving step (``infer_rgbd``: FPS and normals on the card) at batch
   8, the batched eval step on ``make_batch``'s host clouds (host FPS and
   normals) and 3 train steps, each launching ``knn`` and ``group_feat``
   once a step and no other kernel, each with a float32 step on the card
   against the CPU (the CPU replaying the card's neighbour selections);
   the serving frames/s at batch 8 and 32 beside the default config's;
   device FPS on the card against the CPU bit for bit (random and
   wrap-padded clouds), the normals at the chosen pixels of near and far
   hands against the CPU where the det guard is taken, against the float64
   solve where it is not, with the share of points whose guard takes the
   other branch, and each one's ms a call; the CLI with ``--sample_strategy FPS
   --input_feature_num 6``: ``--mode train`` 2 steps, then ``--mode
   test``;
12. (run after phase 11; its CLI part inside phase 7, on that tree) the
   HandNet options at the full width of the default ``Config``: (a)
   ``photometric_loss=True``: the train step at batch 8 in bf16 (launches
   ``knn_group_xyz`` and ``group_feat`` once), s a step beside the step
   without the photometric terms, the peak of
   ``torch.cuda.max_memory_allocated`` (under the card's 80 GB) and the
   renders' share of the step, and a float32 step at batch 2 on the card
   against the CPU (the CPU replaying the card's face ids, neighbours and
   activations), the photometric and silhouette terms and the texture and
   light heads' gradients printed; (b) ``patch_heads``, ``s2d_stem`` and
   ``use_img_attn`` together: the eval step (``sa_group_l1`` 1,
   ``sa_group_l2`` 1, ``sa_mlp_max`` 2) and the serving step (``knn`` 2,
   ``fused_bottleneck_s1`` 8) at batch 8, each in float32 on the card
   against the CPU, and the patch heads against the full-map heads at the
   centers on the card; (c) the eval step with ``knn_method="approx"`` (no
   kernel) likewise, the CPU replaying the card's bf16 selections; (d) the
   CLI with ``--photometric_loss --image_summary --image_summary_every 1``
   for 2 train steps: a (4 * 384, 3 * 384, 3) grid a step.  Each
   sub-phase prints its seconds;
13. (run after phase 12; its CLI part inside phase 7, on that tree) the CSP
   alternate detector, which launches no port kernel (checked, 0 of each):
   (a) ``Trainer(Config(arch="csp_50"))`` at full width, bf16, batch 8: 3
   warm-up and 10 timed train steps, samples/s, the peak of
   ``torch.cuda.max_memory_allocated`` and the device's busy share over 3
   profiled steps; (b) a float32 train-mode forward at batch 2 on the card
   against the CPU (frozen norms, the CPU replaying the card's ReLUs) and
   ``csp_loss`` with ``replicate_reference_quirks`` off and on: outputs,
   loss terms and gradients within the bounds of phase 5; (c) the same for
   ``csp_18`` with ``use_uv_prior=True`` (quirks off); (d)
   ``crop_and_resize`` forward and backward on the card against the CPU on
   (8, 96, 96, 256) images with 64 boxes at 7x7 and 14x14, and ms a call;
   (e) the CLI with ``--arch csp_50``: ``--mode train`` 2 steps, the
   checkpoint restored bit for bit, ``--mode test`` failing with JAX's
   NotImplementedError.  Each sub-phase prints its seconds;
14. (run after phase 13; its CLI part inside phase 7, on that tree)
   data-parallel training (``parallel/mesh.py``) on a one-rank NCCL group
   (``maybe_initialize_distributed`` on a free local port): ``Trainer`` at
   full width, bf16, batch 8, 3 steps on ``make_batch``'s batches, once
   replicated and once with ``zero1_opt_sharding``, each counted (one
   launch of ``knn_group_xyz`` and of ``group_feat`` a step, added to their
   ``launches``) and held to the same 3 steps without a process group:
   every step's loss terms and every parameter's move within (b)'s bounds
   of ``tests/test_torch_parallel.py`` or 4x the gap between two runs
   without a group (the card's own run-to-run spread: atomics), both
   printed; samples/s, peak memory, the device's busy share and the time
   of one gradient all-reduce; ``fit`` for 2 steps in the group (ZeRO-1,
   its collective save); then ``cli.main --mode train --coordinator
   127.0.0.1:<port> --num_processes 1 --process_id 0`` for 2 steps against
   the same command without the flags: the checkpoints within the same
   bounds;
15. (run after phase 14) the 2-D (data x model) layout on a one-rank NCCL
   group: ``make_mesh_2d(1, 1)`` and ``shard_params_tp`` (every split leaf
   a whole slice; the column-parallel and gather code runs with its NCCL
   calls) under the train step (bf16, batch 8, 3 steps: one launch of
   ``knn_group_xyz`` and of ``group_feat`` a step), the eval step
   (``sa_group_l1`` 1, ``sa_group_l2`` 1, ``sa_mlp_max`` 2) and the serving
   step (``knn`` 2, ``fused_bottleneck_s1`` 8 on gathered, folded
   weights), each counted (added to ``launches``) and held to the same
   runs without a group: bit for bit expected, else phase 14's bounds or
   4x the gap between two runs without a group, both printed; samples/s
   and frames/s beside the same steps without a group, peak memory, the
   device's busy share and the NCCL calls a step.

``python3 chip_smoke.py --ranks N`` (on N cards)
runs instead, after the card line, the multi-process path across cards:
``cli.main --mode train --synthetic`` in N processes joined by
``--coordinator`` (one card each, NCCL), 3 float32 steps of the global
batch 8 with frozen BatchNorm and no dropout, an evaluation and a
checkpoint, against the
same command in one process: every process exits 0, the others write
nothing, the first step's loss within 1e-5, the merged scores within 1e-4
and the checkpoint's first Adam moments, as one vector without the leaves
whose gradients cancel, within 1e-2 of the one process's (the float32
order of batch-2 ranks against batch 8).  With N = 4 it then runs the
(2 data x 2 model) layout in 4 NCCL processes (``--tp_rank i``, one card
each): 3 float32 train steps at lr 1e-7 with frozen BatchNorm and no
dropout on the global batches of 8 and the eval step, against one
process: the model peers bit for bit alike, the first step's loss terms
and gradients within ``tests/test_torch_parallel.py``'s bounds, the eval
outputs within 1e-4 of their scale.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so every float32 number, the
cuDNN and cuBLAS yardsticks' too, is true float32; the checks of phases 4
and 6 marked so run the port's float32 steps under torch's default flags
instead, and the CLI subprocesses of ``--ranks`` run under the CLI's own
setting.  The line before the last lists the kernels as JSON; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
BATCH = 8
# Published peaks of one H100 SXM (dense): HBM bytes/s, float32 CUDA-core
# and bf16 tensor-core operations/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
# float32 sums of up to 256 products in another order than cuBLAS's
MLP_TOL_F32 = dict(atol=1e-4, rtol=1e-4)
# bf16-rounded hidden activations can land one bf16 step (2**-8) apart when
# the float32 sums before the rounding differ in order
MLP_TOL_BF16 = dict(atol=1e-2, rtol=1e-2)
# the float32 eval step on the card against the CPU: convolutions summed in
# another order through ResNet-50, relative to each output's magnitude
STEP_TOL = 1e-3
# the grouping backward passes on the card against the CPU: scatter_add_ sums
# a point's cotangents in atomic order on the card, in index order on the
# CPU; float32 rounding of such sums stays far below 1e-5 of the largest
GROUP_BWD_TOL = 1e-5
# the float32 train step on the card against the CPU at batch 2: each loss
# term relative to its magnitude, and each gradient within GRAD_TOL of its
# parameter's largest gradient entry (plus GRAD_TOL relative).  Forward and
# backward sum ResNet-50's convolutions in other orders (cuDNN against the
# CPU's kernels), ~1e-6 relative per layer; a wrong gradient is off by O(1).
LOSS_TOL = 1e-3
GRAD_TOL = 5e-3
TRAIN_WARMUP, TRAIN_ITERS = 3, 10
# the fused bottleneck against its plain version, relative to the output's
# largest magnitude: float32 sums of up to 2304 products in another order;
# in bf16 a y1/y2 element rounded one bf16 step (2**-8) apart moves an
# output by about that much of its scale
TRUNK_TOL_F32 = 1e-4
TRUNK_TOL_BF16 = 1e-2

SOURCES = {"sa_group_l1": ("pdfnet_tpu_torch/csrc/sa_group.cu",
                           "pdfnet_tpu/ops/pallas_knn.py:172"),
           "sa_group_l2": ("pdfnet_tpu_torch/csrc/sa_group.cu",
                           "pdfnet_tpu/ops/pallas_knn.py:107"),
           "sa_mlp_max": ("pdfnet_tpu_torch/csrc/sa_mlp.cu",
                          "pdfnet_tpu/ops/pallas_knn.py:201"),
           "knn_group_xyz": ("pdfnet_tpu_torch/csrc/sa_group.cu",
                             "pdfnet_tpu/ops/pallas_knn.py:82"),
           "group_feat": ("pdfnet_tpu_torch/csrc/sa_group.cu",
                          "pdfnet_tpu/ops/pallas_knn.py:107"),
           "knn": ("pdfnet_tpu_torch/csrc/sa_group.cu",
                   "pdfnet_tpu/ops/pallas_knn.py:70"),
           "fused_bottleneck_s1": ("pdfnet_tpu_torch/csrc/trunk_block.cu",
                                   "pdfnet_tpu/ops/pallas_trunk.py:148"),
           "fused_bottleneck_s2": ("pdfnet_tpu_torch/csrc/trunk_block.cu",
                                   "pdfnet_tpu/ops/pallas_trunk.py:198")}
# what the selection kernels' yardsticks compute (timed only, never called
# by the port; no single PyTorch call makes an exact kNN selection, so
# library_ms is null)
YARD_KNN = "d2 by broadcasting, torch.topk"
YARD_ROWS = YARD_KNN + ", gather, ball where"
EVAL_KERNELS = ("sa_group_l1", "sa_group_l2", "sa_mlp_max")
TRAIN_KERNELS = ("knn_group_xyz", "group_feat")
SERVE_KERNELS = ("knn", "fused_bottleneck_s1")
# the ResNet-50 blocks at 384x384, batch 8: (name, H = W of the input, Cin,
# Cw, stride); stride-1 blocks per serving step: 3 at layer2, 5 at layer3
TRUNK_CASES = (("layer2_1", 48, 512, 128, 1), ("layer3_1", 24, 1024, 256, 1),
               ("layer2_0", 96, 256, 128, 2), ("layer3_0", 48, 512, 256, 2),
               ("layer4_0", 24, 1024, 512, 2))
TRUNK_PER_STEP = {"layer2_1": 3, "layer3_1": 5}
# the float32 stride-1 body's tiles beside the one ops/trunk.f32_plan takes
# (rows, tile width, blocks a cluster): whole width without a cluster,
# narrower tiles with their halo columns recomputed, clusters of 2
TRUNK_F32_PLANS = {"layer2_1": ((2, 48, 1), (6, 24, 1), (3, 24, 1)),
                   "layer3_1": ((2, 24, 1), (3, 24, 1), (3, 12, 1),
                                (2, 12, 1), (2, 24, 2))}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(fail(msg))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def torch_default_tf32():
    """torch's default TF32 flags inside (cuDNN's on, cuBLAS's off), the
    script's (both off) after: the port's float32 steps must set TF32 off
    themselves."""
    import torch
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """ms of one call of ``fn`` by CUDA-graph replay: ``iters`` calls
    captured in one graph after a warm-up call, the graph replayed
    ``replays`` times between CUDA events, so that host launch gaps count
    for nothing.  Back-to-back calls find their inputs in L2, as
    ``time_ms``'s do."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


# ---- phase 3: kernels against their plain versions -------------------------

def kernel_inputs(cfg, gen, dev):
    """Inputs of the main path's shapes at batch 8 (16 hands): xyz on a 1/256
    grid for half the hands (every distance exact, so exact ties occur) and
    continuous for the other half, spread so that both sides of each ball
    radius are hit; level-2 rows carry 128 random features."""
    import torch
    H, N = 2 * BATCH, cfg.sample_num
    xyz = torch.rand((H, N, 3), generator=gen) * 0.4 - 0.2
    xyz[: H // 2] = torch.round(xyz[: H // 2] * 256) / 256
    n2 = cfg.sample_num_level1
    feat = torch.cat([xyz[:, :n2], torch.randn((H, n2, 128), generator=gen)],
                     dim=-1)
    return xyz.to(dev).contiguous(), feat.to(dev).contiguous()


def folded_mlp(widths, cin, gen, dev):
    import torch
    out = []
    for f in widths:
        w = torch.randn((cin, f), generator=gen) / cin ** 0.5
        b = torch.rand((f,), generator=gen) * 0.6 - 0.3
        out.append((w.to(dev), b.to(dev)))
        cin = f
    return out


def group_bound(H, N, C, S, k, esize, selection=False):
    """(ms, bound_by): read the rows once, write the groups once (and, with
    ``selection``, each neighbour's int32 index and float32 d2); d2 and one
    compare per (center, point) pair at the float32 rate."""
    bytes_ = (H * N * C + H * S * k * C) * esize + (H * S * k * 8
                                                    if selection else 0)
    ops = H * S * N * 9
    t_b, t_o = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def mlp_bound(H, S, k, C, widths, in_esize, bf16):
    """(ms, bound_by): the groups read once, the pooled output written once;
    2 * k * (C*F1 + F1*F2 + F2*F3) per center at the compute dtype's rate."""
    F1, F2, F3 = widths
    bytes_ = H * S * k * C * in_esize + H * S * F3 * 4
    ops = 2 * H * S * k * (C * F1 + F1 * F2 + F2 * F3)
    t_b = bytes_ / PEAK_BYTES * 1e3
    t_o = ops / (PEAK_BF16 if bf16 else PEAK_F32) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def selection_times(run, plain, yard, what=YARD_ROWS):
    """(graph ms, plain ms, extra text, yardstick ms) of a selection
    entry point: kernel and yardstick by CUDA-graph replay, the kernel
    eagerly beside it, the plain version eagerly."""
    ms, yard_ms = graph_ms(run), graph_ms(yard)
    return (ms, time_ms(plain, iters=5),
            f"; eager_ms {time_ms(run):.4f}; yardstick_ms {yard_ms:.4f} "
            f"({what}; graph replay)", yard_ms)


def kernel_phase(cfg, dev):
    """Every kernel at its path's shapes in float32 and bfloat16, against
    its plain version.  Returns per-kernel numbers of the calls one step of
    its path (eval or train) makes in the default (bf16) compute dtype."""
    import torch
    from pdfnet_tpu_torch.ops import grouping, sa

    gen = torch.Generator().manual_seed(0)
    xyz, feat = kernel_inputs(cfg, gen, dev)
    H, N = xyz.shape[:2]
    S1, S2, k = cfg.sample_num_level1, cfg.sample_num_level2, cfg.knn_k
    r1, r2 = cfg.ball_radius, cfg.ball_radius2
    w1 = folded_mlp(sa.MLP_WIDTHS[0], 3, gen, dev)
    w2 = folded_mlp(sa.MLP_WIDTHS[1], feat.shape[-1], gen, dev)
    steps = {}

    def record(name, case, err, ms, plain_ms, bound, step_case, extra="",
               yardstick_ms=None):
        """step_case: how many times one step of the path makes this call
        (True counts once); the JSON line sums the step's calls."""
        print(f"kernel {name} [{case}]: max_abs_err {err:.3e} ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {bound[0]:.4f} "
              f"({bound[1]}){extra}")
        if step_case:
            n = int(step_case)
            s = steps.setdefault(name, dict(err=0.0, ms=0.0, plain=0.0,
                                            bound=0.0, by={}, yard=None))
            s["err"] = max(s["err"], err)
            s["ms"] += n * ms
            s["plain"] += n * plain_ms
            s["bound"] += n * bound[0]
            s["by"][bound[1]] = s["by"].get(bound[1], 0.0) + n * bound[0]
            if yardstick_ms is not None:
                s["yard"] = (s["yard"] or 0.0) + n * yardstick_ms

    # sa_group_l1: float32 points, as on the main path
    got = sa.sa_group_l1(xyz, S1, k, r1)
    want = sa.group_plain(xyz, S1, k, r1)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err == 0.0, f"sa_group_l1 differs from its plain version ({err})")
    print(f"kernel sa_group_l1: neighbourhoods bit-identical (same "
          f"neighbours, same order); in-ball share "
          f"{(got.abs().sum(-1) > 0).float().mean().item():.3f}")
    ms, plain_ms, extra, yard = selection_times(
        lambda: sa.sa_group_l1(xyz, S1, k, r1),
        lambda: sa.group_plain(xyz, S1, k, r1),
        lambda: topk_group(xyz, S1, k, r1))
    record("sa_group_l1", "f32", err, ms, plain_ms,
           group_bound(H, N, 3, S1, k, 4), True, extra, yard)

    # sa_group_l2: rows in the compute dtype (bf16 on the main path)
    for dt, step_case in ((torch.float32, False), (torch.bfloat16, True)):
        f = feat.to(dt).contiguous()
        got = sa.sa_group_l2(f, S2, k, r2)
        want = sa.group_plain(f, S2, k, r2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err == 0.0, f"sa_group_l2 [{dt}] differs from its plain "
                          f"version ({err})")
        ms, plain_ms, extra, yard = selection_times(
            lambda: sa.sa_group_l2(f, S2, k, r2),
            lambda: sa.group_plain(f, S2, k, r2),
            lambda: topk_group(f, S2, k, r2))
        record("sa_group_l2", str(dt).split(".")[-1], err, ms, plain_ms,
               group_bound(H, S1, f.shape[-1], S2, k, f.element_size()),
               step_case, extra, yard)

    # sa_mlp_max at both levels' shapes, float32 and bf16 compute; the
    # weights already in the compute dtype, so that the timed call is the
    # kernel alone (the model casts them once a step, ops/sa.py)
    g1 = sa.group_plain(xyz, S1, k, r1)
    g2 = sa.group_plain(feat, S2, k, r2)
    for level, g, w in ((1, g1, w1), (2, g2, w2)):
        for cdt in (torch.float32, torch.bfloat16):
            # on the main path level 2 groups bf16 rows in bf16 mode
            gin = g.to(cdt).contiguous() if level == 2 else g
            wc = [(wi.to(cdt), bi) for wi, bi in w]
            got = sa.sa_mlp_max(gin, wc, cdt)
            want = sa.mlp_max_plain(gin, wc, cdt)
            torch.cuda.synchronize()
            tol = MLP_TOL_BF16 if cdt == torch.bfloat16 else MLP_TOL_F32
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **tol)
            check(ok, f"sa_mlp_max level {level} [{cdt}] outside {tol} "
                      f"(max abs {err})")
            C = gin.shape[-1]
            wb = [(wi.to(cdt), bi.to(cdt)) for wi, bi in w]
            yard = graph_ms(lambda: matmul_mlp_max(gin, wb))
            record("sa_mlp_max", f"level {level} {str(cdt).split('.')[-1]}",
                   err, graph_ms(lambda: sa.sa_mlp_max(gin, wc, cdt)),
                   time_ms(lambda: sa.mlp_max_plain(gin, wc, cdt)),
                   mlp_bound(H, gin.shape[1], k, C, sa.MLP_WIDTHS[level - 1],
                             gin.element_size(), cdt == torch.bfloat16),
                   cdt == torch.bfloat16,
                   f"; eager_ms "
                   f"{time_ms(lambda: sa.sa_mlp_max(gin, wc, cdt)):.4f}; "
                   f"yardstick_ms {yard:.4f} (3 torch.matmul + bias, ReLU, "
                   f"amax; graph replay)", yard)

    mlp_cap_check(cfg, xyz, feat, w1, w2)

    # knn_group_xyz: float32 points, the train path's level 1
    got = grouping.knn_group_xyz(xyz, S1, k)
    want = grouping.knn_group_xyz_plain(xyz, S1, k)
    torch.cuda.synchronize()
    err = max((g.double() - w.double()).abs().max().item()
              for g, w in zip(got, want))
    check(err == 0.0, f"knn_group_xyz differs from its plain version ({err})")
    ms, plain_ms, extra, yard = selection_times(
        lambda: grouping.knn_group_xyz(xyz, S1, k),
        lambda: grouping.knn_group_xyz_plain(xyz, S1, k),
        lambda: topk_group(xyz, S1, k, None), YARD_KNN + ", gather")
    record("knn_group_xyz", "f32", err, ms, plain_ms,
           group_bound(H, N, 3, S1, k, 4, selection=True), True, extra, yard)

    # group_feat: rows in the compute dtype (bf16 on the main path)
    for dt, step_case in ((torch.float32, False), (torch.bfloat16, True)):
        f = feat.to(dt).contiguous()
        got = grouping.group_feat(f, S2, k, r2)
        rows, dist, idx = sa.group_select_plain(f, S2, k, r2)
        torch.cuda.synchronize()
        err = max((g.double() - w.double()).abs().max().item()
                  for g, w in zip(got, (rows, idx, dist)))
        check(err == 0.0, f"group_feat [{dt}] differs from its plain version "
                          f"({err})")
        ms, plain_ms, extra, yard = selection_times(
            lambda: grouping.group_feat(f, S2, k, r2),
            lambda: sa.group_select_plain(f, S2, k, r2),
            lambda: topk_group(f, S2, k, r2))
        record("group_feat", str(dt).split(".")[-1], err, ms, plain_ms,
               group_bound(H, S1, f.shape[-1], S2, k, f.element_size(),
                           selection=True), step_case, extra, yard)

    grouping_backward_check(cfg, xyz, feat, gen)
    knn_check(cfg, xyz, record)
    selection_check(gen, dev)
    trunk_check(gen, dev, record)
    return steps


def mlp_cap_check(cfg, xyz, feat, w1, w2) -> None:
    """``sa_mlp_max`` at k = 128 and 256, above the 64 rows a block takes at
    a time (the kernel walks k in chunks of 64), at both levels' widths in
    float32 and bf16 compute, within ``MLP_TOL_*`` of its plain version;
    times by graph replay beside the plain version, the bound and the
    yardstick (not on the main path: printed, not in the kernels line)."""
    import torch
    from pdfnet_tpu_torch.ops import sa

    H = xyz.shape[0]
    S1, S2 = cfg.sample_num_level1, cfg.sample_num_level2
    for k in (128, 256):
        g1 = sa.group_plain(xyz, S1, k, cfg.ball_radius)
        g2 = sa.group_plain(feat, S2, k, cfg.ball_radius2)
        for level, g, w in ((1, g1, w1), (2, g2, w2)):
            for cdt in (torch.float32, torch.bfloat16):
                gin = g.to(cdt).contiguous() if level == 2 else g
                wc = [(wi.to(cdt), bi) for wi, bi in w]
                got = sa.sa_mlp_max(gin, wc, cdt)
                want = sa.mlp_max_plain(gin, wc, cdt)
                torch.cuda.synchronize()
                tol = MLP_TOL_BF16 if cdt == torch.bfloat16 else MLP_TOL_F32
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, **tol),
                      f"sa_mlp_max k={k} level {level} [{cdt}] outside "
                      f"{tol} (max abs {err})")
                wb = [(wi.to(cdt), bi.to(cdt)) for wi, bi in w]
                bound = mlp_bound(H, gin.shape[1], k, gin.shape[-1],
                                  sa.MLP_WIDTHS[level - 1],
                                  gin.element_size(), cdt == torch.bfloat16)
                print(f"kernel sa_mlp_max [k={k} level {level} "
                      f"{str(cdt).split('.')[-1]}]: max_abs_err {err:.3e} ms "
                      f"{graph_ms(lambda: sa.sa_mlp_max(gin, wc, cdt)):.4f} "
                      f"plain_ms "
                      f"{time_ms(lambda: sa.mlp_max_plain(gin, wc, cdt), iters=5):.4f} "
                      f"bound_ms {bound[0]:.4f} ({bound[1]}); yardstick_ms "
                      f"{graph_ms(lambda: matmul_mlp_max(gin, wb)):.4f} "
                      f"(3 torch.matmul + bias, ReLU, amax; graph replay)")


def grouping_backward_check(cfg, xyz, feat, gen) -> None:
    """The train grouping ops' gradients on the card against the CPU, with
    one seeded cotangent: the selection is bit-identical (checked above), so
    only the order of scatter_add_'s sums may differ."""
    import torch
    from pdfnet_tpu_torch.ops import grouping

    S1, S2, k = cfg.sample_num_level1, cfg.sample_num_level2, cfg.knn_k
    cases = [("group_points", xyz,
              lambda x: grouping.group_points(x, k, S1, cfg.ball_radius)[0])]
    for dt in (torch.float32, torch.bfloat16):
        cases.append((f"group_points_level2 [{str(dt).split('.')[-1]}]", feat,
                      lambda x, dt=dt: grouping.group_points_level2(
                          x, S2, k, cfg.ball_radius2, dt)[0]))
    for name, inp, fn in cases:
        grads = []
        for x in (inp, inp.cpu()):
            x = x.clone().requires_grad_(True)
            out = fn(x)
            if not grads:
                cot = torch.randn(out.shape, generator=gen)
            grads.append(torch.autograd.grad(out, x, cot.to(x.device))[0])
        torch.cuda.synchronize()
        got, want = grads[0].cpu(), grads[1]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        print(f"backward {name}: card vs cpu max_abs_err {err:.3e} (scale "
              f"{scale:.3e})")
        check(err <= GROUP_BWD_TOL * scale,
              f"{name} backward on the card differs from the CPU ({err})")


def matmul_mlp_max(g, params):
    """The yardstick of ``sa_mlp_max``: three ``torch.matmul`` with bias
    and ReLU in the weights' dtype, then the max over k (timed only)."""
    import torch
    h = g.to(params[0][0].dtype)
    for w, b in params:
        h = torch.relu(torch.matmul(h, w) + b)
    return h.amax(dim=2).float()


def topk_select(ctr, pts, k):
    """The yardstick of ``knn``: d2 by broadcasting as the plain version
    computes it, then ``torch.topk`` (its tie order may differ)."""
    import torch
    diff = pts[:, None, :, :] - ctr[:, :, None, :]
    d2 = ((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
          + diff[..., 2] * diff[..., 2])
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True)


def topk_group(feat, S, k, r2):
    """The yardstick of the row kernels: ``topk_select`` with the first S
    rows as centers, the row gather, xyz minus center and (unless ``r2`` is
    None) the ball ``where``."""
    import torch
    xyz = feat[..., :3].float()
    ctr = xyz[:, :S]
    dist, idx = topk_select(ctr, xyz, k)
    rows = feat[torch.arange(feat.shape[0], device=feat.device)[:, None, None],
                idx]
    rows = torch.cat([(rows[..., :3].float() - ctr[:, :, None, :]).to(
        feat.dtype), rows[..., 3:]], dim=-1)
    if r2 is None:
        return dist, idx, rows
    own = feat[:, :S, None, :].clone()
    own[..., :3] = 0
    return torch.where((dist <= r2)[..., None], rows, own.expand_as(rows))


def selection_cases(gen):
    """The cases a threshold selection stresses, as (name, xyz (2, N, 3)
    float32 on the CPU, S, k, r2): xyz on a 1/32 grid in [-1/8, 1/8]^3
    (every distance exact: many keys equal the k-th, many rows exactly on
    the radius 1/64, at offsets of 4/32)."""
    import torch

    def grid(n):
        return torch.randint(-4, 5, (2, n, 3), generator=gen).float() / 32
    g, g200 = grid(1024), grid(200)
    bad, few = grid(1024), grid(96)
    bad[:, 40:140] = float("nan")          # clusters larger than k, centers
    bad[:, 300:400, 0] = float("inf")      # inside them too
    few[:, 10:80] = float("nan")           # 16 finite rows: the selection
    few[:, 80:90, 1] = float("inf")        # reaches the non-finite keys
    r = 1.0 / 64
    return [("identical points", torch.full((2, 1024, 3), 0.05), 512, 64, r),
            ("grid ties, on radius", g, 512, 64, r),
            ("grid, k = 8", g, 512, 8, r),
            ("grid, k = 128", g, 512, 128, r),
            ("N = 200", g200, 100, 64, r),
            ("k = N = 200", g200, 200, 200, r),
            ("NaN/inf clusters of 100", bad, 512, 64, r),
            ("70 NaN + 10 inf of 96", few, 96, 64, r),
            # 140 KB of shared memory a block: the launch opts in above 48 KB
            ("k = N = 1024, grid ties", g, 64, 1024, r),
            ("k = N = 1024, NaN/inf clusters", bad, 64, 1024, r)]


def wide_selection_cases(gen):
    """Clouds wider than 1024 points, whose ranked neighbours go to a
    workspace, 16 hands (the main path's batch), as in ``selection_cases``:
    up to 2048 points a lane keeps its 64 keys in registers, beyond it
    recomputes them (N = 2050 and 4096); past the block's shared memory
    the candidate lists spill to the workspace (k = N = 4096; N = 4096,
    k = 3000) and the xyz is read from device memory (N = 20000), each on a
    grid with ties and with NaN/inf clusters.  The last flag marks the
    cases whose level-1 selection is timed."""
    import torch

    def grid(n):
        return torch.randint(-4, 5, (2 * BATCH, n, 3), generator=gen
                             ).float() / 32
    g2k, g4k, g2050, g1500 = grid(2048), grid(4096), grid(2050), grid(1500)
    bad = grid(2048)
    bad[:, 40:140] = float("nan")
    bad[:, 1300:1400, 0] = float("inf")
    cont = torch.rand((2 * BATCH, 4096, 3), generator=gen) * 0.4 - 0.2
    g20k = grid(20000)

    def clusters(xyz):
        out = xyz.clone()
        out[:, 40:140] = float("nan")
        out[:, 1300:1400, 0] = float("inf")
        return out
    r = 1.0 / 64
    return [("N = 2048, grid ties, on radius", g2k, 512, 64, r, True),
            ("N = 4096, grid ties", g4k, 512, 64, r, True),
            ("N = 4096, continuous", cont, 512, 64, r, False),
            ("N = 2050", g2050, 512, 64, r, False),
            ("N = 1500, k = 100", g1500, 512, 100, r, False),
            ("N = 2048, k = 128", g2k, 512, 128, r, True),
            ("k = N = 2048, grid ties", g2k, 64, 2048, r, False),
            ("N = 2048, NaN/inf clusters of 100", bad, 512, 64, r, False),
            ("k = N = 4096, grid ties (lists spilled)", g4k, 32, 4096, r,
             True),
            ("k = N = 4096, NaN/inf clusters", clusters(g4k), 32, 4096, r,
             False),
            ("N = 4096, k = 3000, grid ties (lists spilled)", g4k, 32, 3000,
             r, True),
            ("N = 4096, k = 3000, NaN/inf clusters", clusters(g4k), 32, 3000,
             r, False),
            ("N = 20000, grid ties (xyz in device memory)", g20k, 512, 64, r,
             True),
            ("N = 20000, NaN/inf clusters", clusters(g20k), 512, 64, r,
             False)]


def same(got, want) -> bool:
    """Equal values, NaN equal to NaN; indices compared as int64."""
    import torch
    if not want.is_floating_point():
        return torch.equal(got.long().cpu(), want.long().cpu())
    return torch.equal(got.float().cpu().nan_to_num(7.0),
                       want.float().cpu().nan_to_num(7.0))


def selection_check(gen, dev) -> None:
    """Every selection entry point against its plain version on the cases
    of ``selection_cases`` and ``wide_selection_cases`` (timing sa_group_l1
    on the wide cases marked so), failing on the first difference: ``knn`` with
    the first S rows as centers and with separate centers, ``knn_group_xyz``,
    ``sa_group_l1``, and ``sa_group_l2``/``group_feat`` on rows of 131
    float32 and bf16 channels."""
    import torch
    from pdfnet_tpu_torch.ops import grouping, sa

    cases = [c + (False,) for c in selection_cases(gen)]
    for name, xyz, S, k, r2, timed in cases + wide_selection_cases(gen):
        H, N = xyz.shape[:2]
        feat = torch.cat([xyz, torch.randn((H, N, 128), generator=gen)], -1)
        other = torch.randint(-4, 5, (H, 333, 3), generator=gen).float() / 32
        pts, ctr = xyz.to(dev), other.to(dev)
        calls = [("knn", lambda: sa.knn(pts[:, :S].contiguous(), pts, k),
                  lambda: sa.knn_select_plain(pts[:, :S], pts, k)),
                 ("knn, 333 separate centers", lambda: sa.knn(ctr, pts, k),
                  lambda: sa.knn_select_plain(ctr, pts, k)),
                 ("knn_group_xyz", lambda: grouping.knn_group_xyz(pts, S, k),
                  lambda: grouping.knn_group_xyz_plain(pts, S, k)),
                 ("sa_group_l1", lambda: (sa.sa_group_l1(pts, S, k, r2),),
                  lambda: (sa.group_plain(pts, S, k, r2),))]
        for dt in (torch.float32, torch.bfloat16):
            f = feat.to(dev, dt).contiguous()
            calls += [(f"sa_group_l2 [{dt}]",
                       lambda f=f: (sa.sa_group_l2(f, S, k, r2),),
                       lambda f=f: (sa.group_plain(f, S, k, r2),)),
                      (f"group_feat [{dt}]",
                       lambda f=f: grouping.group_feat(f, S, k, r2),
                       lambda f=f: (lambda g, d, i: (g, i, d))(
                           *sa.group_select_plain(f, S, k, r2)))]
        for call, run, plain in calls:
            got, want = run(), plain()
            torch.cuda.synchronize()
            check(len(got) == len(want)
                  and all(same(g, w) for g, w in zip(got, want)),
                  f"{call} differs from its plain version on {name} "
                  f"(N={N}, S={S}, k={k})")
        print(f"kernel selection [{name}: H={H}, N={N}, S={S}, k={k}]: all "
              f"{len(calls)} entry-point calls equal their plain versions")
        if timed:
            ms, plain_ms, extra, _ = selection_times(
                lambda: sa.sa_group_l1(pts, S, k, r2),
                lambda: sa.group_plain(pts, S, k, r2),
                lambda: topk_group(pts, S, k, r2))
            bound = group_bound(H, N, 3, S, k, 4)
            print(f"kernel sa_group_l1 [H={H}, N={N}, S={S}, k={k}]: ms "
                  f"{ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
                  f"{bound[0]:.4f} ({bound[1]}){extra}")
        del feat, pts, f


def knn_bound(H, N, S, k):
    """(ms, bound_by): points and centers read once, each neighbour's int32
    index and float32 d2 written once; d2 and one compare per (center,
    point) pair at the float32 rate."""
    bytes_ = (H * N + H * S) * 3 * 4 + H * S * k * 8
    t_b, t_o = bytes_ / PEAK_BYTES * 1e3, H * S * N * 9 / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def knn_check(cfg, xyz, record) -> None:
    """``knn`` (K5) at both levels' shapes, its centers the first S rows as
    the main path passes them: bit for bit against the plain version, with
    exact ties (half the hands on a 1/256 grid); NaN/inf clouds are among
    ``selection_cases``."""
    import torch
    from pdfnet_tpu_torch.ops import sa

    H, k = xyz.shape[0], cfg.knn_k
    for level, N, S in ((1, cfg.sample_num, cfg.sample_num_level1),
                        (2, cfg.sample_num_level1, cfg.sample_num_level2)):
        pts = xyz[:, :N].contiguous()
        ctr = pts[:, :S].contiguous()
        dist, idx = sa.knn(ctr, pts, k)
        want_d, want_i = sa.knn_select_plain(ctr, pts, k)
        torch.cuda.synchronize()
        check(torch.equal(dist, want_d) and torch.equal(idx.long(), want_i),
              f"knn level {level} differs from its plain version")
        ties = int((want_d[..., 1:] == want_d[..., :-1]).sum())
        ms, plain_ms, extra, yard = selection_times(
            lambda: sa.knn(ctr, pts, k),
            lambda: sa.knn_select_plain(ctr, pts, k),
            lambda: topk_select(ctr, pts, k), YARD_KNN)
        record("knn", f"level {level}", 0.0, ms, plain_ms,
               knn_bound(H, N, S, k), True,
               f"; bit-identical, {ties} exact ties among the neighbours"
               + extra, yard)


def trunk_bound(B, hw, Cin, Cw, stride, esize, bf16):
    """(ms, bound_by): the map read once and the output written once, the
    folded weights read once; 2 * (Cin*Cw + 9*Cw*Cw + Cw*Cout [+ Cin*Cout])
    operations per output pixel at the compute dtype's rate."""
    Ho, Cout, proj = hw // stride, 4 * Cw, stride == 2
    wts = Cin * Cw + 9 * Cw * Cw + Cw * Cout + (Cin * Cout if proj else 0)
    bytes_ = ((B * hw * hw * Cin + B * Ho * Ho * Cout + wts) * esize
              + 4 * (2 * Cw + Cout * (2 if proj else 1)))
    t_b = bytes_ / PEAK_BYTES * 1e3
    t_o = 2 * B * Ho * Ho * wts / (PEAK_BF16 if bf16 else PEAK_F32) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def random_bottleneck(cin, cw, stride, gen):
    """A port ``Bottleneck`` with seeded weights and BatchNorm away from the
    identity, in eval mode on the CPU."""
    import torch
    from pdfnet_tpu_torch.models.resnet import Bottleneck
    block = Bottleneck(cin, cw, stride, project=stride == 2)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / m.weight[0].numel() ** 0.5)
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.rand(c, generator=gen) * 0.6 - 0.3)
                m.running_mean.copy_(torch.rand(c, generator=gen) * 0.6 - 0.3)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
    return block.eval()


def cudnn_block(x, folded, stride, project, dt):
    """The yardstick of ``fused_bottleneck`` (timed only): cuDNN on the
    folded weights in ``dt``, three ``F.conv2d`` with bias (and the
    projection) on the channels_last map, ReLU and the residual add.
    Returns a function of the NHWC map."""
    import torch
    import torch.nn.functional as F

    def conv_w(w):                       # (kh, kw, Cin, Cout) or (Cin, Cout)
        w = w if w.dim() == 4 else w[None, None]
        return w.permute(3, 2, 0, 1).to(dt).contiguous(
            memory_format=torch.channels_last)
    w = {n: conv_w(v) if n.startswith("w") else v.to(dt)
         for n, v in folded.items()}

    def run(nhwc):
        x = nhwc.permute(0, 3, 1, 2)     # a channels_last view
        y = F.relu(F.conv2d(x, w["w1"], w["b1"]))
        y = F.relu(F.conv2d(y, w["w2"], w["b2"], stride=stride, padding=1))
        sc = F.conv2d(x, w["wp"], w["bp"], stride=stride) if project else x
        return F.relu(F.conv2d(y, w["w3"], w["b3"]) + sc)
    return run


def trunk_check(gen, dev, record) -> None:
    """``fused_bottleneck`` (K6) at the ResNet-50 blocks' shapes at batch 8,
    float32 and bf16, against its plain version; beside each, cuDNN on the
    folded weights (both by CUDA-graph replay) and the port's unfused eval
    ``Bottleneck`` (cuDNN convolutions and BatchNorm under autocast)."""
    import torch
    from pdfnet_tpu_torch.ops import trunk

    for name, hw, cin, cw, stride in TRUNK_CASES:
        block = random_bottleneck(cin, cw, stride, gen).to(dev)
        project = block.project
        with torch.no_grad():
            folded = trunk.fold_bottleneck(block)
        x32 = torch.relu(torch.randn((BATCH, hw, hw, cin), generator=gen))
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            x = x32.to(dev, dt).contiguous()
            # weights already in the compute dtype, so that the timed call
            # is the kernel alone (the trunk casts them once a call)
            fw = {n: v.to(dt) if n.startswith("w") else v
                  for n, v in folded.items()}
            got = trunk.fused_bottleneck(x, fw, stride, project)
            want = trunk.fused_bottleneck_plain(x, fw, stride, project)
            torch.cuda.synchronize()
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            tol = TRUNK_TOL_BF16 if bf16 else TRUNK_TOL_F32
            check(err <= tol * scale, f"fused_bottleneck {name} [{dt}] "
                  f"differs from its plain version by {err:.3e} (scale "
                  f"{scale:.3e}, tolerance {tol} of it)")
            nchw = x.permute(0, 3, 1, 2)         # a channels_last view
            with torch.inference_mode(), torch.autocast(
                    dev.type, dtype=torch.bfloat16, enabled=bf16):
                unfused = time_ms(lambda: block(nchw))
            yard_fn = cudnn_block(x, folded, stride, project, dt)
            with torch.inference_mode():
                yard = graph_ms(lambda: yard_fn(x))
            per_step = (TRUNK_PER_STEP.get(name, 0) if stride == 1 else 1)
            run = lambda: trunk.fused_bottleneck(x, fw, stride, project)
            record(f"fused_bottleneck_s{stride}",
                   f"{name} {str(dt).split('.')[-1]}", err, graph_ms(run),
                   time_ms(lambda: trunk.fused_bottleneck_plain(
                       x, fw, stride, project), iters=5),
                   trunk_bound(BATCH, hw, cin, cw, stride, x.element_size(),
                               bf16), per_step if bf16 else 0,
                   f"; scale {scale:.3e}; eager_ms {time_ms(run):.4f}; "
                   f"yardstick_ms {yard:.4f} (cuDNN on the folded weights, "
                   f"graph replay); unfused Bottleneck (cuDNN, eager) "
                   f"{unfused:.4f} ms", yard)
            if not bf16 and stride == 1:
                trunk_f32_plans(name, x, fw, want, scale,
                                trunk.f32_plan(BATCH, hw, hw, cin, cw))
        del block, folded, x32


def trunk_f32_plans(name, x, fw, want, scale, chosen) -> None:
    """The float32 stride-1 body at the tiles of ``TRUNK_F32_PLANS`` beside
    the chosen one, each within TRUNK_TOL_F32 of the plain version, by
    CUDA-graph replay (printed, not in the kernels line)."""
    import torch
    from pdfnet_tpu_torch.ops import trunk
    plan_of = trunk.f32_plan
    for plan in TRUNK_F32_PLANS[name]:
        trunk.f32_plan = lambda *a, plan=plan: plan
        try:
            got = trunk.fused_bottleneck(x, fw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= TRUNK_TOL_F32 * scale, f"fused_bottleneck {name} "
                  f"[float32, plan {plan}] differs from its plain version "
                  f"by {err:.3e}")
            ms = graph_ms(lambda: trunk.fused_bottleneck(x, fw))
        finally:
            trunk.f32_plan = plan_of
        print(f"kernel fused_bottleneck_s1 [{name} float32, tile {plan} "
              f"(rows, width, cluster) against the chosen {chosen}]: "
              f"max_abs_err {err:.3e} ms {ms:.4f}")


# ---- phase 4: the eval step ------------------------------------------------

def bench_batch(B, res, n, seed=0):
    """The bench's batch layout (bench.py:57-68), from the port's bench
    entry."""
    from pdfnet_tpu_torch.bench import random_batch
    return random_batch(B, res, n, seed)


def jitter_bn_(model, seed: int) -> None:
    """Seeded BatchNorm running statistics away from (0, 1), so the folds
    and the norms are not the identity."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.rand(m.running_mean.shape,
                                                generator=gen) * 0.6 - 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=gen) * 1.5 + 0.5)


def fps(step, batch, B, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        out = step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(batch)
    torch.cuda.synchronize()
    del out
    return B * iters / (time.perf_counter() - t0)


def eval_phase(args, card, cfg, dev):
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.ops import grouping, sa, trunk

    cfg32 = cfg.replace(compute_dtype="float32")
    res, n = cfg.default_resolution, cfg.sample_num
    model = port.build_model(cfg, device=dev)
    jitter_bn_(model, seed=1)
    consts = port.load_loss_consts(dev)
    step = port.make_eval_step(cfg, model, consts)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in bench_batch(BATCH, res, n).items()}

    # the main path, once, through the user's entry points
    for m in (sa, grouping, trunk):
        m.reset_launches()
    out = step(batch)
    torch.cuda.synchronize()
    launches = {**sa.launches, **grouping.launches, **trunk.launches}
    print(f"eval step [bf16, batch {BATCH}] kernel launches: "
          f"{json.dumps(launches)}")
    check(all(launches[n] > 0 for n in EVAL_KERNELS),
          f"a kernel of the eval path was not launched: {launches}")
    check(sum(launches[n] for n in EVAL_KERNELS) == 4
          and not any(launches[n] for n in launches if n not in EVAL_KERNELS),
          f"expected 4 eval launches and no other kernel: {launches}")
    shapes = {"verts_pred": (BATCH, 2, 778, 3), "joints_pred": (BATCH, 2, 21, 3),
              "verts_pred_off": (BATCH, 2, 778, 3),
              "joints_pred_off": (BATCH, 2, 21, 3),
              "lms21_pred": (BATCH, 2, 21, 2)}
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape, f"{key} {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out[key]).all()), f"{key} not finite")
    print(f"eval step [bf16] outputs: shapes ok, finite; |verts_pred| max "
          f"{out['verts_pred'].abs().max().item():.4f}")

    # float32 on the card against the same weights on the CPU, batch 1
    state = model.state_dict()
    m32 = port.HandNet(cfg32).to(dev).eval()
    m32.load_state_dict(state)
    mcpu = port.HandNet(cfg32).eval()
    mcpu.load_state_dict({k: v.cpu() for k, v in state.items()})
    b1 = {k: v[:1] for k, v in batch.items()}
    want = port.make_eval_step(cfg32, mcpu, port.load_loss_consts("cpu"))(
        {k: v.cpu() for k, v in b1.items()})
    # as the script runs (TF32 off), then with torch's default flags, under
    # which the step must set TF32 off itself
    for flags, ctx in (("", contextlib.nullcontext),
                       (", torch's default TF32 flags", torch_default_tf32)):
        with ctx():
            got = port.make_eval_step(cfg32, m32, consts)(b1)
            torch.cuda.synchronize()
        worst = 0.0
        for key in want:
            g, w = got[key].cpu(), want[key]
            scale = max(1.0, w.abs().max().item())
            err = (g - w).abs().max().item()
            worst = max(worst, err / scale)
            print(f"eval step [f32, batch 1{flags}] card vs cpu {key}: "
                  f"max_abs_err {err:.3e} (scale {scale:.3e})")
            check(torch.allclose(g, w, atol=STEP_TOL * scale, rtol=STEP_TOL),
                  f"f32 eval step{flags} on the card differs from the CPU "
                  f"in {key}")
        print(f"eval step [f32{flags}] card agrees with cpu: worst error / "
              f"scale {worst:.3e} <= {STEP_TOL}")

    # the float32 step's launches (its own bodies), not the main path's
    step32 = port.make_eval_step(cfg32, m32, consts)
    for m in (sa, grouping, trunk):
        m.reset_launches()
    step32(batch)
    torch.cuda.synchronize()
    l32 = {**sa.launches, **grouping.launches, **trunk.launches}
    print(f"eval step [f32, batch {BATCH}] kernel launches: "
          f"{json.dumps(l32)}")
    check(l32 == launches, f"the f32 eval step launched other kernels "
          f"than the bf16 step: {l32}")

    # throughput, host clock around synchronized loops, TF32 off
    big = {k: torch.from_numpy(v).to(dev)
           for k, v in bench_batch(4 * BATCH, res, n, seed=1).items()}
    for dt, st, b, B in (("bf16", step, batch, BATCH),
                         ("f32", step32, batch, BATCH),
                         ("bf16", step, big, 4 * BATCH),
                         ("f32", step32, big, 4 * BATCH)):
        print(f"eval step frames/s [{dt}, batch {B}]: {fps(st, b, B):.2f} "
              f"({card})")
    if args.profile:
        for b, B in ((batch, BATCH), (big, 4 * BATCH)):
            profile(lambda b=b: step(b), f"eval_bf16_b{B}")
            profile(lambda b=b: step32(b), f"eval_f32_b{B}")
    return launches


def cap_eval_check(cfg, dev) -> None:
    """One float32 eval step at ``sample_num=2048``, ``knn_k=128`` (past the
    1024 points and 64 rows of the first kernels) at batch 1, on the card
    (its wide selection and chunked MLP) against the same model on the CPU
    (plain versions), within STEP_TOL of each output's magnitude."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.ops import sa

    c = cfg.replace(sample_num=2048, knn_k=128, compute_dtype="float32")
    model = port.build_model(c, device=dev)
    jitter_bn_(model, seed=4)
    mcpu = port.HandNet(c).eval()
    mcpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    host = bench_batch(1, c.default_resolution, c.sample_num, seed=2)
    sa.reset_launches()
    got = port.make_eval_step(c, model, port.load_loss_consts(dev))(host)
    torch.cuda.synchronize()
    check(sa.launches["sa_group_l1"] == 1 and sa.launches["sa_mlp_max"] == 2,
          f"eval step at N=2048, k=128 did not run the kernels: {sa.launches}")
    want = port.make_eval_step(c, mcpu, port.load_loss_consts("cpu"))(host)
    worst = 0.0
    for key in want:
        g, w = got[key].cpu(), want[key]
        check(bool(torch.isfinite(g).all()), f"{key} not finite")
        scale = max(1.0, w.abs().max().item())
        worst = max(worst, (g - w).abs().max().item() / scale)
        check(torch.allclose(g, w, atol=STEP_TOL * scale, rtol=STEP_TOL),
              f"f32 eval step at N=2048, k=128: card differs from the CPU "
              f"in {key}")
    print(f"eval step [f32, batch 1, sample_num 2048, knn_k 128] card agrees "
          f"with cpu: worst error / scale {worst:.3e} <= {STEP_TOL}")


# ---- phase 5: the train step -----------------------------------------------

def train_phase(args, card, cfg, dev):
    """The train step at batch 8 in bf16 (the main path, counted) and in
    float32.  Returns the kernels' launches in one bf16 step."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.ops import grouping, sa, trunk

    t0 = time.perf_counter()
    host = port.make_batch(cfg, BATCH, seed=0)
    print(f"train batch [{BATCH}] made on the host in "
          f"{time.perf_counter() - t0:.1f} s; valid hands "
          f"{int(host['valid'].sum())} of {2 * BATCH}")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    consts = port.load_loss_consts(dev)
    launches = None
    for dt in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=dt)
        model = port.build_model(c, device=dev)
        state = port.create_train_state(c, model)
        step = port.make_train_step(c, model, consts)
        gen = torch.Generator(device=dev).manual_seed(0)
        lr = port.lr_at_epoch(c, 0)
        params0 = [p.detach().clone() for p in model.parameters()]
        stats0 = [b.clone() for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))]
        run = lambda: step(state, batch, 0, lr, gen)

        losses = []
        if launches is None:
            # the main path, once, through the user's entry points
            for m in (sa, grouping, trunk):
                m.reset_launches()
            losses.append(run()["loss"])
            torch.cuda.synchronize()
            launches = {**sa.launches, **grouping.launches, **trunk.launches}
            print(f"train step [bf16, batch {BATCH}] kernel launches: "
                  f"{json.dumps(launches)}")
            check(all(launches[n] == 1 for n in TRAIN_KERNELS)
                  and not any(launches[n] for n in launches
                              if n not in TRAIN_KERNELS),
                  f"expected one launch of each train kernel and no other "
                  f"kernel: {launches}")
        while len(losses) < TRAIN_WARMUP:
            losses.append(run()["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            losses.append(run()["loss"])
        torch.cuda.synchronize()
        rate = BATCH * TRAIN_ITERS / (time.perf_counter() - t0)
        losses = torch.stack(losses).cpu()
        check(bool(torch.isfinite(losses).all()),
              f"train step [{dt}]: a loss is not finite: {losses.tolist()}")
        moved = sum(bool((p.detach() != q).any())
                    for p, q in zip(model.parameters(), params0))
        stats1 = [b for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))]
        bn_moved = sum(bool((a != b).any()) for a, b in zip(stats1, stats0))
        print(f"train step [{dt}, batch {BATCH}]: losses "
              f"{', '.join(f'{v:.1f}' for v in losses.tolist())}; "
              f"{moved}/{len(params0)} parameters and {bn_moved}/{len(stats0)} "
              f"BatchNorm statistics moved")
        check(moved > 0.9 * len(params0) and bn_moved > 0.9 * len(stats0),
              f"train step [{dt}]: parameters or statistics did not move")
        print(f"train step samples/s [{dt}, batch {BATCH}]: {rate:.2f} "
              f"({card})")
        if args.profile and dt == "bfloat16":
            profile(run, f"train_bf16_b{BATCH}")
            big = {k: torch.from_numpy(v).to(dev) for k, v in
                   port.make_batch(c, 4 * BATCH, seed=1).items()}
            profile(lambda: step(state, big, 0, lr, gen),
                    f"train_bf16_b{4 * BATCH}")
            del big
        del model, state, step
    return launches


def train_check_phase(cfg, dev):
    """One float32 train step on the card against the same step on the CPU
    at batch 2, with frozen BatchNorm and no dropout (live BatchNorm at
    random init amplifies float32 noise): every loss term and every
    parameter's gradient.

    The two sides compute the clouds' float32 xyz with other summation
    orders, so a neighbour on a tie or on the ball's radius can be selected
    on one side and not on the other, which moves its cotangent to another
    row.  Likewise an activation within rounding of 0 can pass its ReLU (or
    take a leaky ReLU's other slope) on one side only: in a point MLP, when
    that point wins the max-pool for some channels, it carries their whole
    gradient (seen: 9.6e-3 of a leaf's largest entry, in some runs of the
    same inputs, as the card's float32 sums vary in their last bit between
    runs); with six-channel clouds, flips outside the point MLPs (in the
    SFT, FPN and head layers) moved a mesh-decoder embedding's gradient by
    5.3e-3 of its largest entry.  The CPU step therefore
    replays the card's neighbour selection (the kernels' own agreement is
    checked bit for bit in the kernel phase) and every ReLU and leaky-ReLU
    decision in the model's modules (the encoder, PointNet++, layers,
    ResNet, attention and mesh decoder), and the flips are counted and
    printed.  With ``photometric_loss`` the renderer's depth test likewise
    picks a pixel's face from float32 vertices that differ in the last bit
    (a pixel on an edge), so the CPU replays the card's face ids too; the
    photometric terms and the texture and light heads' gradients are
    printed."""
    import types
    import torch
    import torch.nn.functional as F
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.models import (attention, encoder, gcn_decoder,
                                         layers, pointnet, resnet)
    from pdfnet_tpu_torch.ops import grouping, sa
    from pdfnet_tpu_torch.render import rasterizer

    c = cfg.replace(compute_dtype="float32", freeze_bn_stats=True,
                    dropout=0.0)
    host = port.make_batch(c, 2, seed=1)
    chosen, flips = [], [0, 0]
    relu_masks, relu_flips = [], [0, 0]

    def record_relu(x, slope=0.0):
        relu_masks.append((x > 0).cpu())
        return F.leaky_relu(x, slope) if slope else F.relu(x)

    def replay_relu(x, slope=0.0):
        card = relu_masks.pop(0)
        relu_flips[0] += int(((x > 0) != card).sum())
        relu_flips[1] += card.numel()
        return torch.where(card, x, x * slope)

    def functional(act):
        """torch.nn.functional with relu and leaky_relu through ``act``."""
        ns = {n: getattr(F, n) for n in dir(F) if not n.startswith("_")}
        ns.update(relu=act, leaky_relu=act)
        return types.SimpleNamespace(**ns)
    act_modules = (attention, encoder, gcn_decoder, layers, pointnet, resnet)
    depth_test, fids, fid_flips = rasterizer._depth_test, [], [0, 0]

    def record_fid(*a, **k):
        fid = depth_test(*a, **k)
        fids.append(fid.cpu())
        return fid

    def replay_fid(*a, **k):
        card = fids.pop(0)
        fid_flips[0] += int((depth_test(*a, **k) != card).sum())
        fid_flips[1] += card.numel()
        return card

    wrappers = {"knn_group_xyz": lambda out: (out[0], out[1]),
                "group_feat": lambda out: (out[2], out[1]),
                "knn": lambda out: (out[0], out[1])}
    originals = {n: getattr(grouping, n) for n in wrappers}

    def recording(name):
        def run(*a, **k):
            out = originals[name](*a, **k)
            chosen.append(tuple(t.cpu() for t in wrappers[name](out)))
            return out
        return run

    def replay(xyz, num_centers, k):
        return replay_knn(xyz[:, :num_centers], xyz, k)

    def replay_knn(centers, points, k):
        dist, idx = sa.knn_select_plain(centers, points, k)
        card_dist, card_idx = chosen.pop(0)
        flips[0] += int((idx != card_idx.long()).sum())
        flips[1] += idx.numel()
        return card_dist, card_idx.long()

    runs = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        model = port.build_model(c, device=d)
        jitter_bn_(model, seed=2)
        step = port.make_train_step(c, model, port.load_loss_consts(d))
        if i == 0:
            patches = [(grouping, n, recording(n)) for n in wrappers]
            patches += [(m, "F", functional(record_relu))
                        for m in act_modules]
            patches.append((rasterizer, "_depth_test", record_fid))
        else:
            patches = [(grouping, "knn_plain", replay),
                       (sa, "knn_plain", replay),
                       (grouping, "knn", replay_knn)]
            patches += [(m, "F", functional(replay_relu))
                        for m in act_modules]
            patches.append((rasterizer, "_depth_test", replay_fid))
        saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
        try:
            for m, n, fn in patches:
                setattr(m, n, fn)
            stats = step(port.create_train_state(c, model), host, 30,
                         port.lr_at_epoch(c, 0))
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)
        runs.append(({k: v.cpu() for k, v in stats.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None}))
    check(not chosen and not relu_masks and not fids,
          "the CPU step grouped, ran an activation or rendered fewer times "
          "than the card's")
    if fid_flips[1]:
        print(f"train step [f32, batch 2]: the CPU's own depth test picks "
              f"another face than the card's at {fid_flips[0]} of "
              f"{fid_flips[1]} pixels; the CPU step replays the card's")
    print(f"train step [f32, batch 2]: the CPU's own neighbour selection "
          f"differs from the card's in {flips[0]} of {flips[1]} slots "
          f"(float32 ties and radius crossings), its ReLU decisions in "
          f"{relu_flips[0]} of {relu_flips[1]}; the CPU step replays the "
          f"card's")
    (got_s, got_g), (want_s, want_g) = runs
    worst = 0.0
    for key, w in want_s.items():
        err = (got_s[key] - w).abs().item()
        scale = max(w.abs().item(), 1e-6)
        worst = max(worst, err / scale)
        check(err <= LOSS_TOL * scale,
              f"f32 train step: {key} {got_s[key].item()} on the card, "
              f"{w.item()} on the CPU")
    print(f"train step [f32, batch 2] card vs cpu: {len(want_s)} loss terms "
          f"within {LOSS_TOL} (worst relative error {worst:.3e})")
    for key in ("photometric_loss", "seg_loss"):
        if key in want_s:
            print(f"train step [f32, batch 2] {key}: card "
                  f"{got_s[key].item():.6e}, cpu {want_s[key].item():.6e}")
    check(sorted(got_g) == sorted(want_g),
          "the card and the CPU reach different parameters")
    errs = {}
    for name, w in want_g.items():
        if name.endswith("wk.bias"):
            # attention key biases cancel in the softmax: their gradient is
            # analytically zero, and its float32 value is rounding noise
            continue
        scale = max(w.abs().max().item(), 1e-12)
        errs[name] = ((got_g[name] - w).abs()
                      - GRAD_TOL * w.abs()).max().item() / scale
    worst = sorted(errs, key=errs.get, reverse=True)[:5]
    print(f"train step [f32, batch 2] card vs cpu: gradient error / scale, "
          f"worst: {', '.join(f'{n} {errs[n]:.3e}' for n in worst)}")
    heads = [n for n in errs if n.startswith(("encoder.head_texture",
                                              "encoder.head_light"))]
    if heads:
        print(f"train step [f32, batch 2] card vs cpu: texture and light "
              f"heads' gradient error / scale: "
              f"{', '.join(f'{n} {errs[n]:.3e}' for n in heads)}")
    check(errs[worst[0]] <= GRAD_TOL,
          f"f32 train step: gradient of {worst[0]} differs by "
          f"{errs[worst[0]]:.3e} of its scale")
    print(f"train step [f32, batch 2] card vs cpu: {len(errs)} gradients "
          f"within {GRAD_TOL} of their scale")


# ---- phase 6: the self-contained serving step ------------------------------

SERVE_INPUTS = ("input", "depth", "K_new", "valid")


def split_masks_(model, img) -> None:
    """Shift the mask head's bias so that each hand's predicted mask covers
    about half the images (its median maps to 0.5): at random weights the
    mask is nearly constant, and the clouds would be empty or whole-image.
    The bilinear resizes after the head keep a constant shift."""
    import torch
    with torch.inference_mode():
        mask = model.encoder.image_phase(img.permute(0, 3, 1, 2), aux=False,
                                         need_mask=True)[1]
        med = mask.float().transpose(0, 1).flatten(1).median(dim=1).values
    with torch.no_grad():
        model.encoder.dp_decoder.head.bias += 0.5 - med


def make_serve_step(cfg, model, consts, gen):
    """The serving step of the JAX ``cli/infer.py:143-151``: ``infer_rgbd``
    composed with ``eval_outputs(..., {"K_new": K})``; returns the outputs
    and ``other``."""
    import torch
    import pdfnet_tpu_torch as port

    def step(b):
        with torch.inference_mode():
            out = port.infer_rgbd(model, *(b[k] for k in SERVE_INPUTS), gen)
            return (port.eval_outputs(cfg, consts, *out, {"K_new": b["K_new"]}),
                    out[3])
    return step


def serve_phase(args, card, cfg, dev):
    """The serving step at batch 8 in bf16 (the main path, counted), its
    outputs, a float32 check against the CPU, and frames/s.  Returns the
    kernels' launches in one bf16 step."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.ops import grouping, sa, trunk

    scfg = cfg.replace(knn_method="pallas", fused_trunk=True)
    res, n = cfg.default_resolution, cfg.sample_num
    model = port.build_model(scfg, device=dev)
    jitter_bn_(model, seed=3)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in bench_batch(BATCH, res, n).items()}
    split_masks_(model, batch["input"])
    consts = port.load_loss_consts(dev)
    step = make_serve_step(scfg, model, consts,
                           torch.Generator(device=dev).manual_seed(0))

    # the main path, once, through the user's entry points
    for m in (sa, grouping, trunk):
        m.reset_launches()
    out, other = step(batch)
    torch.cuda.synchronize()
    launches = {**sa.launches, **grouping.launches, **trunk.launches}
    print(f"serve step [bf16, batch {BATCH}] kernel launches: "
          f"{json.dumps(launches)}")
    others = [n for n in launches if n not in SERVE_KERNELS]
    check(launches["knn"] == 2 and launches["fused_bottleneck_s1"] == 8
          and not any(launches[n] for n in others),
          f"expected 2 knn and 8 fused_bottleneck_s1 launches and no other "
          f"kernel: {launches}")
    shapes = {"verts_pred": (BATCH, 2, 778, 3), "joints_pred": (BATCH, 2, 21, 3),
              "verts_pred_off": (BATCH, 2, 778, 3),
              "joints_pred_off": (BATCH, 2, 21, 3),
              "lms21_pred": (BATCH, 2, 21, 2)}
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape, f"{key} {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out[key]).all()), f"{key} not finite")
    ind = other["ind"]
    check(tuple(ind.shape) == (BATCH, 2) and bool((ind >= 0).all())
          and bool((ind < (res // cfg.down_ratio) ** 2).all()),
          f"decoded centers out of range: {ind.tolist()}")
    share = (other["mask"] > 0.5).float().mean(dim=(0, 1, 2)).tolist()
    print(f"serve step [bf16] outputs: shapes ok, finite, centers in range; "
          f"mask share > 0.5 [left, right] {share[1]:.3f}, {share[0]:.3f}; "
          f"|verts_pred| max {out['verts_pred'].abs().max().item():.4f}")

    state = model.state_dict()
    serve_check_phase(scfg, state, batch, dev)
    with torch_default_tf32():
        serve_check_phase(scfg, state, batch, dev,
                          ", torch's default TF32 flags")

    # the float32 step's launches (its own bodies), not the main path's
    s32 = scfg.replace(compute_dtype="float32")
    m32 = port.HandNet(s32).to(dev).eval()
    m32.load_state_dict(state)
    step32 = make_serve_step(s32, m32, consts,
                             torch.Generator(device=dev).manual_seed(0))
    for m in (sa, grouping, trunk):
        m.reset_launches()
    step32(batch)
    torch.cuda.synchronize()
    l32 = {**sa.launches, **grouping.launches, **trunk.launches}
    print(f"serve step [f32, batch {BATCH}] kernel launches: "
          f"{json.dumps(l32)}")
    check(l32 == launches, f"the f32 serving step launched other kernels "
          f"than the bf16 step: {l32}")

    # throughput, host clock around synchronized loops, TF32 off
    mdef = port.HandNet(cfg).to(dev).eval()
    mdef.load_state_dict(state)
    step_def = make_serve_step(cfg, mdef, consts,
                               torch.Generator(device=dev).manual_seed(0))
    big = {k: torch.from_numpy(v).to(dev)
           for k, v in bench_batch(4 * BATCH, res, n, seed=1).items()}
    for label, st, b, B in (("bf16", step, batch, BATCH),
                            ("f32", step32, batch, BATCH),
                            ("bf16", step, big, 4 * BATCH),
                            ("f32", step32, big, 4 * BATCH),
                            ("bf16, default config: pallas_sa, unfused trunk",
                             step_def, batch, BATCH)):
        print(f"serve step frames/s [{label}, batch {B}]: "
              f"{fps(st, b, B):.2f} ({card})")
    if args.profile:
        for b, B in ((batch, BATCH), (big, 4 * BATCH)):
            profile(lambda b=b: step(b), f"serve_bf16_b{B}")
            profile(lambda b=b: step32(b), f"serve_f32_b{B}")
    del m32, mdef, big
    return launches


class SelectionReplay:
    """The card's neighbour selections, recorded in call order and replayed
    by the CPU's step: ``grouping.knn`` (both levels under
    ``knn_method="pallas"``, level 1 of six-channel clouds) and
    ``grouping.group_feat`` (level 2 of six-channel clouds at eval).  A
    neighbour on a tie or on the ball radius can fall on either side when
    the two devices' float32 xyz differ in the last bit; the kernels' own
    agreement with their plain versions is checked bit for bit in the
    kernel phase.  ``flips`` counts the slots where the CPU's own selection
    differs."""

    def __init__(self):
        self.knn, self.feat = [], []
        self.flips = dict(neighbours=0, slots=0)

    def _count(self, own_idx, card_idx):
        self.flips["neighbours"] += int((own_idx != card_idx.long()).sum())
        self.flips["slots"] += own_idx.numel()

    def patches(self, card: bool):
        from pdfnet_tpu_torch.ops import grouping, sa
        if card:
            knn, group_feat = grouping.knn, grouping.group_feat

            def record_knn(*a, **k):
                out = knn(*a, **k)
                self.knn.append(tuple(t.cpu() for t in out))
                return out

            def record_feat(*a, **k):
                out = group_feat(*a, **k)
                self.feat.append((out[2].cpu(), out[1].cpu()))
                return out
            return [(grouping, "knn", record_knn),
                    (grouping, "group_feat", record_feat)]
        knn_plain = sa.knn_plain

        def replay_knn(centers, points, k):
            own = sa.knn_select_plain(centers, points, k)
            card_dist, card_idx = self.knn.pop(0)
            self._count(own[1], card_idx)
            return card_dist, card_idx.long()

        def replay_feat(xyz, num_centers, k):
            own = knn_plain(xyz, num_centers, k)
            card_dist, card_idx = self.feat.pop(0)
            self._count(own[1], card_idx)
            return card_dist, card_idx.long()
        return [(grouping, "knn", replay_knn), (sa, "knn_plain", replay_feat)]

    def done(self) -> bool:
        return not self.knn and not self.feat


def run_patched(patches, fn):
    """fn() with each (module, name, value) of ``patches`` set, restored
    after."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, v in patches:
            setattr(m, n, v)
        return fn()
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def compare_steps(label, got, want) -> None:
    """Every output of a float32 step on the card within STEP_TOL of the
    CPU's, relative to each output's magnitude."""
    import torch
    worst = 0.0
    for key in want:
        g, w = got[key], want[key]
        check(bool(torch.isfinite(g).all()), f"{label}: {key} not finite")
        scale = max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        worst = max(worst, err / scale)
        print(f"{label} card vs cpu {key}: max_abs_err {err:.3e} (scale "
              f"{scale:.3e})")
        check(torch.allclose(g, w, atol=STEP_TOL * scale, rtol=STEP_TOL),
              f"{label}: the card differs from the CPU in {key}")
    print(f"{label} card agrees with cpu: worst error / scale {worst:.3e} "
          f"<= {STEP_TOL}")


def serve_check_phase(scfg, state, batch, dev, flags: str = "") -> None:
    """One float32 serving step on the card against the same step on the
    CPU at batch 1, with deterministic point sampling (``flags`` names the
    TF32 flags it runs under, for the printed lines).

    A predicted-mask pixel at 0.5, or a depth at a band edge, can fall on
    either side on the two devices, and a neighbour on a tie or on the ball
    radius likewise; the CPU step therefore replays the card's clouds and
    neighbour selections (``SelectionReplay``), and the flips are counted
    and printed."""
    import torch
    import pdfnet_tpu_torch as port
    import pdfnet_tpu_torch.models.handnet as handnet

    c = scfg.replace(compute_dtype="float32", sample_deterministic=True)
    b1 = {k: batch[k][:1] for k in SERVE_INPUTS}
    clouds, replay = [], SelectionReplay()
    flips = dict(mask=0, choose=0)
    build_clouds = handnet.depth_to_hand_clouds

    def record_clouds(depth, mask, *a, **k):
        out = build_clouds(depth, mask, *a, **k)
        clouds.append((mask.cpu(), *(t.cpu() for t in out)))
        return out

    def replay_clouds(depth, mask, *a, **k):
        own = build_clouds(depth, mask, *a, **k)
        card_mask, *card = clouds.pop(0)
        flips["mask"] += int(((mask > 0.5) != (card_mask > 0.5)).sum())
        flips["choose"] += int((own[0] != card[0]).sum())
        return tuple(card)

    runs = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        model = port.HandNet(c).to(d).eval()
        model.load_state_dict({k: v.to(d) for k, v in state.items()})
        patches = [(handnet, "depth_to_hand_clouds",
                    record_clouds if i == 0 else replay_clouds)]
        step = make_serve_step(c, model, port.load_loss_consts(d), None)
        out, _ = run_patched(patches + replay.patches(card=i == 0),
                             lambda: step({k: v.to(d)
                                           for k, v in b1.items()}))
        runs.append({k: v.cpu() for k, v in out.items()})
    check(not clouds and replay.done(),
          "the CPU step built clouds or selected fewer times than the card's")
    print(f"serve step [f32, batch 1{flags}]: the CPU's own masks differ "
          f"from the card's in {flips['mask']} pixels, its clouds in "
          f"{flips['choose']} chosen pixels, its neighbour selection in "
          f"{replay.flips['neighbours']} of {replay.flips['slots']} slots; "
          f"the CPU step replays the card's")
    compare_steps(f"serve step [f32, batch 1{flags}]", *runs)


# ---- phase 11 (run after phase 6): FPS and surface normals ----------------

NORMALS = dict(sample_strategy="FPS", input_feature_num=6)
# one step of a six-channel path: level 1 the generic kNN + exact gather
# (``knn``), level 2 the fused feature grouping (``group_feat``); the fused
# SA kernels group xyz clouds only
NORMALS_LAUNCHES = {"knn": 1, "group_feat": 1}
# the device normals where the det guard is taken on both devices, card
# against CPU: a normalized sum of 25 points (float32 sums in another order)
NORMAL_TOL_GUARDED = 1e-5
# where both solve the 3x3 plane fit, each device against the float64 solve
# of the same neighbourhoods, within NORMAL_SOLVE_ULPS * cond(A^T A) units
# of float32 rounding: forming A^T A (sums of 25 products) and the LU solve
# with partial pivoting each err by a few units relative to its inputs, and
# the solution by up to cond times that (near-degenerate neighbourhoods at
# a hand's border reach cond ~1e5)
NORMAL_SOLVE_ULPS = 64


def port_launches():
    from pdfnet_tpu_torch.ops import grouping, sa, trunk
    return {**sa.launches, **grouping.launches, **trunk.launches}


def reset_port_launches() -> None:
    from pdfnet_tpu_torch.ops import grouping, sa, trunk
    for m in (sa, grouping, trunk):
        m.reset_launches()


def check_launches(label: str, want) -> dict:
    """The launches since the last reset are exactly ``want`` (0 for every
    kernel not named)."""
    launches = port_launches()
    print(f"{label} kernel launches: {json.dumps(launches)}")
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"{label}: expected launches {want}, got {launches}")
    return launches


def check_outputs(label: str, out, B: int) -> None:
    import torch
    shapes = {"verts_pred": (B, 2, 778, 3), "joints_pred": (B, 2, 21, 3),
              "verts_pred_off": (B, 2, 778, 3),
              "joints_pred_off": (B, 2, 21, 3), "lms21_pred": (B, 2, 21, 2)}
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape,
              f"{label}: {key} {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out[key]).all()),
              f"{label}: {key} not finite")


def fps_normals_alone(card, ncfg, host, dev) -> None:
    """Device FPS on the card against the CPU, bit for bit, on random and
    wrap-padded clouds at the serving path's shapes; the device normals on
    the card against the CPU at the same pixels, with the share of points
    whose det guard takes the other branch; each one's ms a call at batch
    8 (eager: both are chains of small launches, as the model runs
    them)."""
    import torch
    from pdfnet_tpu_torch.ops import fps as fps_ops
    from pdfnet_tpu_torch.ops.geometry import NORMAL_DET_MIN, plane_normals
    from pdfnet_tpu_torch.ops.pointcloud import (depth_to_hand_clouds,
                                                 neighbourhoods)

    B, N = BATCH, ncfg.sample_num
    n1, n2 = ncfg.sample_num_level1, ncfg.sample_num_level2
    gen = torch.Generator().manual_seed(11)
    xyz = torch.randn((B, 2, N, 3), generator=gen) * 0.03
    xyz[..., 2] += 0.5
    wrapped = xyz.clone().reshape(2 * B, N, 3)
    for h in range(2 * B):            # 40..1000 distinct points, repeated
        k = 40 + 60 * h
        wrapped[h] = wrapped[h, :k].repeat(-(-N // k), 1)[:N]
    for label, pts in (("random", xyz), ("wrap-padded",
                                         wrapped.reshape(B, 2, N, 3))):
        want = fps_ops.fps_two_level_order(pts, n1, n2)
        got = fps_ops.fps_two_level_order(pts.to(dev), n1, n2).cpu()
        check(torch.equal(got, want), f"FPS [{label}]: the card's order "
              f"differs from the CPU's in {int((got != want).sum())} places")
        print(f"FPS [{label} clouds, {2 * B} hands of {N}, levels {n1}/{n2}]"
              f": the card's permutations equal the CPU's bit for bit")

    def fit(depth, choose, K_inv):
        nb = neighbourhoods(depth, choose, K_inv)
        ata = torch.einsum("...ki,...kj->...ij", nb, nb)
        return nb, torch.linalg.det(ata), plane_normals(nb)

    res = ncfg.default_resolution
    rnd = bench_batch(B, res, N, seed=5)
    # at 0.55 m every point takes the det guard; three times as far most
    # points solve the plane fit (det grows as z**6)
    cases = (("synthetic hands, 0.55 m", host["depth"], host["mask"],
              host["K_new"], host["valid"]),
             ("synthetic hands, 1.65 m", host["depth"] * 3, host["mask"],
              host["K_new"], host["valid"]),
             ("bench's random depth", rnd["depth"],
              (rnd["input"][..., :2] > 0).astype("float32"), rnd["K_new"],
              rnd["valid"]))
    for label, depth, mask, K, valid in cases:
        depth, mask, K, valid = (torch.from_numpy(a[:B]) for a in
                                 (depth, mask, K, valid))
        # mask channels are [right, left]; the cloud builder takes [left,
        # right]
        choose, _, ok = depth_to_hand_clouds(depth, mask.flip(-1), K, valid,
                                             num_points=N, deterministic=True)
        dm = torch.where((mask.flip(-1) > 0.5).permute(0, 3, 1, 2),
                         torch.where((depth > 0.2) & (depth < 2.5), depth,
                                     0.0)[:, None], 0.0)
        K_inv = torch.linalg.inv(K)[:, None]
        nb, det_c, n_c = fit(dm, choose, K_inv)
        _, det_g, n_g = (t.cpu() for t in fit(dm.to(dev), choose.to(dev),
                                               K_inv.to(dev)))
        sel = ok[..., None].expand_as(det_c)
        guard_c, guard_g = det_c < NORMAL_DET_MIN, det_g < NORMAL_DET_MIN
        flips = (guard_c != guard_g) & sel
        both_g, both_s = guard_c & guard_g & sel, ~guard_c & ~guard_g & sel
        err_g = ((n_g - n_c).abs().amax(-1)[both_g].max().item()
                 if both_g.any() else 0.0)
        n_pts, n_flip = int(sel.sum()), int(flips.sum())
        print(f"normals [{label}, {n_pts} points]: det guard taken at "
              f"{float(guard_c[sel].float().mean()):.4f} of them; the card "
              f"takes the other branch than the CPU at {n_flip} "
              f"({n_flip / max(1, n_pts):.2e} of the points); card vs cpu "
              f"where both guard: max error {err_g:.3e} (<= "
              f"{NORMAL_TOL_GUARDED})")
        check(err_g <= NORMAL_TOL_GUARDED,
              f"normals [{label}]: the card differs from the CPU")
        check(n_flip <= 0.01 * n_pts,
              f"normals [{label}]: {n_flip} det-guard flips")
        if both_s.any():
            nb64 = nb[both_s].double()
            ata64 = torch.einsum("nki,nkj->nij", nb64, nb64)
            n64 = torch.linalg.solve(ata64, nb64.sum(1)[..., None])[..., 0]
            n64 = n64 / n64.norm(dim=-1, keepdim=True)
            cond = torch.linalg.cond(ata64)
            bound = NORMAL_SOLVE_ULPS * cond * 2.0 ** -24
            errs = {side: (n[both_s].double() - n64).abs().amax(-1)
                    for side, n in (("card", n_g), ("cpu", n_c))}
            ratio = {s: float((e / bound).max()) for s, e in errs.items()}
            print(f"normals [{label}]: {int(both_s.sum())} points solve on "
                  f"both; cond(A^T A) median {float(cond.median()):.3e}, max "
                  f"{float(cond.max()):.3e}; max error against the float64 "
                  f"solve: card {float(errs['card'].max()):.3e}, cpu "
                  f"{float(errs['cpu'].max()):.3e}; worst error / "
                  f"({NORMAL_SOLVE_ULPS} cond u): card {ratio['card']:.3e}, "
                  f"cpu {ratio['cpu']:.3e} (<= 1)")
            check(max(ratio.values()) <= 1.0,
                  f"normals [{label}]: a solved normal is further from the "
                  f"float64 solve than its conditioning allows")

    pts = xyz.to(dev)
    ms_fps = time_ms(lambda: fps_ops.fps_two_level_order(pts, n1, n2),
                     iters=5, warmup=1)
    dm, choose, K_inv = dm.to(dev), choose.to(dev), K_inv.to(dev)
    ms_nrm = time_ms(lambda: plane_normals(neighbourhoods(dm, choose,
                                                          K_inv)), iters=10)
    print(f"FPS two-level order [batch {B}: {2 * B} hands of {N}, levels "
          f"{n1}/{n2}]: {ms_fps:.3f} ms a call; normals at the chosen "
          f"pixels [batch {B}, {2 * B * N} points]: {ms_nrm:.3f} ms a call "
          f"(eager, CUDA events) ({card})")


def normals_phase(card, cfg, dev) -> None:
    """``Config(sample_strategy="FPS", input_feature_num=6)`` at the full
    width of the default ``Config``: the self-contained serving step, the
    batched eval step on host clouds with FPS and normals, the train step,
    each with its launches (``knn`` and ``group_feat`` once a step, no
    other kernel) and a float32 step on the card against the CPU; frames/s
    of the serving step beside the default config's; FPS and the normals
    alone."""
    import torch
    import pdfnet_tpu_torch as port

    ncfg = cfg.replace(**NORMALS)
    res, n = ncfg.default_resolution, ncfg.sample_num
    consts = port.load_loss_consts(dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in bench_batch(BATCH, res, n).items()}

    # the self-contained serving step, once, through the user's entry points
    model = port.build_model(ncfg, device=dev)
    jitter_bn_(model, seed=6)
    split_masks_(model, batch["input"])
    step = make_serve_step(ncfg, model, consts,
                           torch.Generator(device=dev).manual_seed(0))
    reset_port_launches()
    out, other = step(batch)
    torch.cuda.synchronize()
    check_launches(f"fps+normals serve step [bf16, batch {BATCH}]",
                   NORMALS_LAUNCHES)
    check_outputs("fps+normals serve step", out, BATCH)
    share = (other["mask"] > 0.5).float().mean(dim=(0, 1, 2)).tolist()
    print(f"fps+normals serve step [bf16] outputs: shapes ok, finite; mask "
          f"share > 0.5 [left, right] {share[1]:.3f}, {share[0]:.3f}")
    state = model.state_dict()
    serve_check_phase(ncfg, state, batch, dev)
    big = {k: torch.from_numpy(v).to(dev)
           for k, v in bench_batch(4 * BATCH, res, n, seed=1).items()}
    mdef = port.build_model(cfg, device=dev)
    jitter_bn_(mdef, seed=6)
    split_masks_(mdef, batch["input"])
    step_def = make_serve_step(cfg, mdef, consts,
                               torch.Generator(device=dev).manual_seed(0))
    for label, st in (("FPS + normals", step), ("default config", step_def)):
        for b, B in ((batch, BATCH), (big, 4 * BATCH)):
            print(f"serve step frames/s [bf16, {label}, batch {B}]: "
                  f"{fps(st, b, B, iters=10):.2f} ({card})")
    del mdef, step_def, big

    # the batched eval step on host clouds (host FPS + normals)
    t0 = time.perf_counter()
    host = port.make_batch(ncfg, BATCH, seed=0)
    print(f"fps+normals batch [{BATCH}] made on the host in "
          f"{time.perf_counter() - t0:.1f} s; valid hands "
          f"{int(host['valid'].sum())} of {2 * BATCH}; cloud "
          f"{host['cloud'].shape}")
    check(host["cloud"].shape == (BATCH, 2, n, 6), "make_batch: not 6 "
          "channels")
    evstep = port.make_eval_step(ncfg, model, consts)
    reset_port_launches()
    out = evstep(host)
    torch.cuda.synchronize()
    check_launches(f"fps+normals eval step [bf16, batch {BATCH}]",
                   NORMALS_LAUNCHES)
    check_outputs("fps+normals eval step", out, BATCH)
    c32 = ncfg.replace(compute_dtype="float32")
    runs, replay = [], SelectionReplay()
    b1 = {k: v[:1] for k, v in host.items()}
    for i, d in enumerate((dev, torch.device("cpu"))):
        m = port.HandNet(c32).to(d).eval()
        m.load_state_dict({k: v.to(d) for k, v in state.items()})
        st = port.make_eval_step(c32, m, port.load_loss_consts(d))
        got = run_patched(replay.patches(card=i == 0), lambda: st(b1))
        runs.append({k: v.cpu() for k, v in got.items()})
    check(replay.done(), "the CPU eval step selected fewer times than the "
          "card's")
    print(f"fps+normals eval step [f32, batch 1]: the CPU's own neighbour "
          f"selection differs from the card's in "
          f"{replay.flips['neighbours']} of {replay.flips['slots']} slots; "
          f"the CPU step replays the card's")
    compare_steps("fps+normals eval step [f32, batch 1]", *runs)
    del model, step, evstep

    # the train step: 3 steps, the first counted
    model = port.build_model(ncfg, device=dev)
    state = port.create_train_state(ncfg, model)
    tstep = port.make_train_step(ncfg, model, consts)
    gen = torch.Generator(device=dev).manual_seed(0)
    params0 = [p.detach().clone() for p in model.parameters()]
    reset_port_launches()
    losses = [tstep(state, host, 0, port.lr_at_epoch(ncfg, 0), gen)["loss"]]
    torch.cuda.synchronize()
    check_launches(f"fps+normals train step [bf16, batch {BATCH}]",
                   NORMALS_LAUNCHES)
    losses += [tstep(state, host, 0, port.lr_at_epoch(ncfg, 0), gen)["loss"]
               for _ in range(2)]
    losses = torch.stack(losses).cpu()
    moved = sum(bool((p.detach() != q).any())
                for p, q in zip(model.parameters(), params0))
    print(f"fps+normals train step [bf16, batch {BATCH}]: losses "
          f"{', '.join(f'{v:.1f}' for v in losses.tolist())}; {moved}/"
          f"{len(params0)} parameters moved")
    check(bool(torch.isfinite(losses).all()) and moved > 0.9 * len(params0),
          "fps+normals train step: a loss is not finite or the parameters "
          "did not move")
    del model, state, tstep
    train_check_phase(ncfg, dev)

    fps_normals_alone(card, ncfg, host, dev)


def normals_cli_phase(tree: str, work: str) -> None:
    """The train/eval CLI with ``--sample_strategy FPS --input_feature_num
    6`` on phase 7's H2O-format tree: ``--mode train`` for 2 steps, then
    ``--mode test`` from its checkpoint; launches, score files."""
    import numpy as np
    import torch
    from pdfnet_tpu_torch.cli.main import main as cli_main

    out = os.path.join(work, "out_normals")
    common = ["--cache_path", tree, "--pre_fix", tree, "--output_path", out,
              "--batch_size", str(BATCH), "--eval_batch_size", str(BATCH),
              "--sample_strategy", "FPS", "--input_feature_num", "6"]
    reset_port_launches()
    t0 = time.perf_counter()
    trainer = cli_main(["--mode", "train", "--num_epochs", "1", "--steps",
                        "2", "--eval_every", "0", "--save_every", "1"]
                       + common)
    torch.cuda.synchronize()
    check(trainer.state.step == 2, "cli fps+normals train: not 2 steps")
    check_launches(f"cli fps+normals --mode train [bf16, batch {BATCH}, 2 "
                   f"steps; {time.perf_counter() - t0:.1f} s]",
                   {n: 2 * v for n, v in NORMALS_LAUNCHES.items()})
    ckpt = os.path.join(out, "ckpt", "default", "model_0")
    del trainer
    batches = -(-CLI_TEST // BATCH)
    reset_port_launches()
    t0 = time.perf_counter()
    cli_main(["--mode", "test", "--load_model", ckpt] + common)
    torch.cuda.synchronize()
    check_launches(f"cli fps+normals --mode test [{CLI_TEST} records, "
                   f"{batches} batches; {time.perf_counter() - t0:.1f} s]",
                   {n: batches * v for n, v in NORMALS_LAUNCHES.items()})
    text = open(os.path.join(out, "H2O-val.txt")).read()
    vals = [float(line.split(": ")[1]) for line in text.splitlines()[1:]]
    with open(os.path.join(out, "hand_poses.json")) as f:
        sub = json.load(f)
    entries = [x for k, v in sub.items() if k != "modality"
               for x in v.values()]
    check(len(vals) == 8 and all(np.isfinite(vals)) and len(entries)
          == CLI_TEST and all(len(x) == 126 and np.isfinite(x).all()
                              for x in entries),
          f"cli fps+normals test: H2O-val.txt or hand_poses.json:\n{text}")
    print(f"cli fps+normals: trained 2 steps, tested {CLI_TEST} records; "
          f"metrics {vals}")


# ---- phase 12 (run after phase 11): the HandNet options ---------------------

PHOTOMETRIC = dict(photometric_loss=True)
# the eval step's and the serving step's graph options, all three together
GRAPH_OPTIONS = dict(patch_heads=True, s2d_stem=True, use_img_attn=True)
# the photometric train step launches the train grouping kernels as the
# default one does; the options' eval step the fused SA kernels, their
# serving step (knn_method="pallas", fused_trunk) knn and the fused blocks;
# knn_method="approx" no kernel
PHOTOMETRIC_LAUNCHES = {"knn_group_xyz": 1, "group_feat": 1}
OPTIONS_EVAL_LAUNCHES = {"sa_group_l1": 1, "sa_group_l2": 1, "sa_mlp_max": 2}
OPTIONS_SERVE_LAUNCHES = {"knn": 2, "fused_bottleneck_s1": 8}
# the patch heads against the full-map heads gathered at the centers, on the
# card in float32: the same sums by two convolution algorithms, relative to
# each head's largest value
PATCH_HEAD_TOL = 1e-4
CARD_MEMORY = 80e9


def photometric_phase(card, cfg, dev) -> None:
    """(a) ``photometric_loss=True``: the train step at batch 8 in bf16
    once through the user's entry points (its launches), then s a step, the
    peak of ``torch.cuda.max_memory_allocated`` (it must fit the card), the
    renders' device time (CUDA events around each ``render_two_hands`` of
    the loss: their forward) and the step without the photometric terms
    beside it; then a float32 step at batch 2 on the card against the CPU
    (``train_check_phase``, face ids replayed)."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.train import loss as loss_mod

    pcfg = cfg.replace(**PHOTOMETRIC)
    consts = port.load_loss_consts(dev)
    host = port.make_batch(pcfg, BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    rates = {}
    for label, c in (("photometric", pcfg), ("without photometric", cfg)):
        model = port.build_model(c, device=dev)
        state = port.create_train_state(c, model)
        step = port.make_train_step(c, model, consts)
        gen = torch.Generator(device=dev).manual_seed(0)
        run = lambda: step(state, batch, 0, port.lr_at_epoch(c, 0), gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        if label == "photometric":
            reset_port_launches()
            stats = run()
            torch.cuda.synchronize()
            check_launches(f"photometric train step [bf16, batch {BATCH}]",
                           PHOTOMETRIC_LAUNCHES)
            check(bool(torch.isfinite(stats["loss"])) and float(
                stats["photometric_loss"]) > 0, f"photometric train step: "
                f"loss {float(stats['loss'])}, photometric_loss "
                f"{float(stats['photometric_loss'])}")
            print(f"photometric train step [bf16, batch {BATCH}]: loss "
                  f"{float(stats['loss']):.2f}, photometric_loss "
                  f"{float(stats['photometric_loss']):.5f}, seg_loss "
                  f"{float(stats['seg_loss']):.5f}")
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        spans = []
        render = loss_mod.render_two_hands

        def timed_render(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = render(*a, **k)
            ev[1].record()
            spans.append(ev)
            return out
        t0 = time.perf_counter()
        n = 3
        run_patched([(loss_mod, "render_two_hands", timed_render)],
                    lambda: [run() for _ in range(n)])
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / n
        render_ms = sum(a.elapsed_time(b) for a, b in spans) / n
        rates[label] = sec
        print(f"train step [bf16, batch {BATCH}, {label}]: {sec:.4f} s a "
              f"step; peak memory allocated {peak / 2**30:.2f} GiB; renders "
              f"(forward, {len(spans) // n} a step) {render_ms:.2f} ms a "
              f"step = {render_ms / 1e3 / sec:.3f} of the step ({card})")
        check(peak < CARD_MEMORY, f"train step [{label}]: peak "
              f"{peak / 1e9:.1f} GB does not fit the card")
        del model, state, step
    extra = rates["photometric"] - rates["without photometric"]
    print(f"photometric train step: {rates['photometric']:.4f} s against "
          f"{rates['without photometric']:.4f} s without the photometric "
          f"terms (the texture and light heads, the renders and their "
          f"backward: {extra:.4f} s a step)")
    train_check_phase(pcfg, dev)


def check_patch_heads(ocfg, state, img, dev) -> None:
    """On the card in float32: the patch heads at the decoded centers
    against the full-map heads of the same weights gathered there."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.ops.gather import gather_pixels

    heads = {}
    for patch in (True, False):
        c = ocfg.replace(compute_dtype="float32", patch_heads=patch,
                         **PHOTOMETRIC)
        model = port.HandNet(c).to(dev).eval()
        # the photometric heads keep the first model's random weights
        model.load_state_dict(state, strict=False)
        state = model.state_dict()
        with torch.inference_mode():
            _, _, ret, ind, _ = model.encoder.image_phase(
                img.permute(0, 3, 1, 2), aux=True)
        heads[patch] = (ret, ind)
        del model
    (rp, ind), (rf, ind_f) = heads[True], heads[False]
    check(torch.equal(ind, ind_f), "patch heads: the centers differ")
    worst = 0.0
    for h, v in rp.items():
        if h == "hm":
            continue
        want = gather_pixels(rf[h].permute(0, 2, 3, 1), ind)
        scale = max(1e-6, want.abs().max().item())
        err = (v - want).abs().max().item() / scale
        worst = max(worst, err)
        check(err <= PATCH_HEAD_TOL, f"patch head {h}: {err:.3e} of scale "
              f"from the full-map head at the centers")
    print(f"patch heads [f32, batch {img.shape[0]}] on the card: "
          f"{', '.join(h for h in rp if h != 'hm')} at the centers equal "
          f"the full-map heads within {worst:.3e} of scale (<= "
          f"{PATCH_HEAD_TOL})")


def graph_options_phase(card, cfg, dev) -> None:
    """(b) ``patch_heads``, ``s2d_stem`` and ``use_img_attn`` together: the
    eval step (``pallas_sa``) and the serving step (``knn_method="pallas"``,
    ``fused_trunk``) at batch 8 in bf16 once (their launches and outputs),
    each in float32 on the card against the CPU at batch 1, and the patch
    heads against the full-map heads on the card; (c) the eval step with
    ``knn_method="approx"`` (no kernel) likewise, the CPU replaying the
    card's bf16 selections."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.ops import grouping

    ocfg = cfg.replace(**GRAPH_OPTIONS)
    res, n = cfg.default_resolution, cfg.sample_num
    consts = port.load_loss_consts(dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in bench_batch(BATCH, res, n).items()}

    t0 = time.perf_counter()
    model = port.build_model(ocfg, device=dev)
    jitter_bn_(model, seed=7)
    reset_port_launches()
    out = port.make_eval_step(ocfg, model, consts)(batch)
    torch.cuda.synchronize()
    check_launches(f"options eval step [bf16, batch {BATCH}]",
                   OPTIONS_EVAL_LAUNCHES)
    check_outputs("options eval step", out, BATCH)
    state = model.state_dict()
    c32 = ocfg.replace(compute_dtype="float32")
    runs = []
    for d in (dev, torch.device("cpu")):
        m = port.HandNet(c32).to(d).eval()
        m.load_state_dict({k: v.to(d) for k, v in state.items()})
        got = port.make_eval_step(c32, m, port.load_loss_consts(d))(
            {k: v[:1].to(d) for k, v in batch.items()})
        runs.append({k: v.cpu() for k, v in got.items()})
    compare_steps("options eval step [f32, batch 1]", *runs)
    check_patch_heads(ocfg, state, batch["input"][:2], dev)
    print(f"options eval phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scfg = ocfg.replace(knn_method="pallas", fused_trunk=True)
    model = port.HandNet(scfg).to(dev).eval()
    model.load_state_dict(state)
    split_masks_(model, batch["input"])
    step = make_serve_step(scfg, model, consts,
                           torch.Generator(device=dev).manual_seed(0))
    reset_port_launches()
    out, _ = step(batch)
    torch.cuda.synchronize()
    check_launches(f"options serve step [bf16, batch {BATCH}]",
                   OPTIONS_SERVE_LAUNCHES)
    check_outputs("options serve step", out, BATCH)
    serve_check_phase(scfg, model.state_dict(), batch, dev)
    print(f"options serving phase: {time.perf_counter() - t0:.1f} s")
    del model, step

    # (c) knn_method="approx": the bf16 selection in plain PyTorch
    t0 = time.perf_counter()
    acfg = cfg.replace(knn_method="approx")
    model = port.build_model(acfg, device=dev)
    jitter_bn_(model, seed=8)
    reset_port_launches()
    out = port.make_eval_step(acfg, model, consts)(batch)
    torch.cuda.synchronize()
    check_launches(f"approx eval step [bf16, batch {BATCH}]", {})
    check_outputs("approx eval step", out, BATCH)
    state = model.state_dict()
    a32 = acfg.replace(compute_dtype="float32")
    select, chosen, flips = grouping.approx_select, [], [0, 0]

    def record(d2, k):
        got = select(d2, k)
        chosen.append(tuple(t.cpu() for t in got))
        return got

    def replay(d2, k):
        own = select(d2, k)
        card = chosen.pop(0)
        flips[0] += int((own[1] != card[1]).sum())
        flips[1] += own[1].numel()
        return card
    runs = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        m = port.HandNet(a32).to(d).eval()
        m.load_state_dict({k: v.to(d) for k, v in state.items()})
        st = port.make_eval_step(a32, m, port.load_loss_consts(d))
        got = run_patched([(grouping, "approx_select",
                            record if i == 0 else replay)],
                          lambda: st({k: v[:1].to(d)
                                      for k, v in batch.items()}))
        runs.append({k: v.cpu() for k, v in got.items()})
    check(not chosen, "approx: the CPU selected fewer times than the card")
    print(f"approx eval step [f32, batch 1]: the CPU's own bf16 selection "
          f"differs from the card's in {flips[0]} of {flips[1]} slots; the "
          f"CPU step replays the card's")
    compare_steps("approx eval step [f32, batch 1]", *runs)
    print(f"approx phase: {time.perf_counter() - t0:.1f} s")


def options_phase(card, cfg, dev) -> None:
    """Phase 12: the photometric train step, then the graph options and
    ``approx``, each sub-phase timed."""
    t0 = time.perf_counter()
    photometric_phase(card, cfg, dev)
    print(f"photometric phase: {time.perf_counter() - t0:.1f} s")
    graph_options_phase(card, cfg, dev)


def options_cli_phase(tree: str, work: str) -> None:
    """(d) ``cli.main --mode train --photometric_loss --image_summary
    --image_summary_every 1`` for 2 steps on phase 7's H2O-format tree:
    the grid file of each step written, (4 * res, 3 * res, 3) uint8 at
    batch 8 (input | prediction | ground truth of the first 4 samples)."""
    import cv2
    import torch
    from pdfnet_tpu_torch.cli.main import main as cli_main

    out = os.path.join(work, "out_photometric")
    t0 = time.perf_counter()
    trainer = cli_main(["--mode", "train", "--num_epochs", "1", "--steps",
                        "2", "--eval_every", "0", "--save_every", "0",
                        "--cache_path", tree, "--pre_fix", tree,
                        "--output_path", out, "--batch_size", str(BATCH),
                        "--photometric_loss", "--image_summary",
                        "--image_summary_every", "1"])
    torch.cuda.synchronize()
    res = trainer.cfg.default_resolution
    check(trainer.state.step == 2, "cli photometric train: not 2 steps")
    grids = sorted(os.path.join(d, f) for d, _, fs in os.walk(out)
                   for f in fs if f.endswith(".png"))
    shapes = [cv2.imread(g).shape for g in grids]
    check([os.path.basename(g) for g in grids] == ["train_00000001.png",
                                                   "train_00000002.png"]
          and all(sh == (min(4, BATCH) * res, 3 * res, 3)
                  for sh in shapes),
          f"cli photometric train: grids {grids} of shapes {shapes}")
    print(f"cli --photometric_loss --image_summary: 2 steps, grids "
          f"{[os.path.basename(g) for g in grids]} of {shapes[0]}; "
          f"{time.perf_counter() - t0:.1f} s")
    del trainer


# ---- phase 13: the CSP alternate detector -----------------------------------

CSP_ARCHS = (("csp_50", dict(arch="csp_50")),
             ("csp_18 + uv prior", dict(arch="csp_18", use_uv_prior=True)))
CROP_CASES = ((8, 96, 96, 256), 64, (7, 14))    # images, boxes, crop sizes
# crop_and_resize card against CPU, relative to the image's (forward) and
# the gradient's (backward) largest magnitude: a sample's coordinate (up to
# 95 here) is rounded to float32 (~8e-6) in another order where the card
# fuses a multiply-add, which moves its bilinear weights by that much and
# an output by up to twice the image's scale times it
CROP_TOL = 1e-4
# the bf16 step's center focal and size terms against float32 on the same
# weights: bf16 logits one step apart move a sigmoid's log by ~2**-8 of
# itself
BF16_LOSS_TOL = 1e-2
# the bf16 forward's outputs (hm, wh, each theta, the uv prior) against
# float32 on the same weights and batch with every norm on the same
# running statistics, in bf16 steps at the output's largest magnitude
# (2**-7 of it, the CPU test's measure): each layer rounds its activations
# to bf16 once.  With batch statistics the two forwards are not compared
# so: at random weights the norms grow a rounding with depth (flax's bf16
# model too), and the gap is printed
BF16_OUT_STEPS = 8
CSP_DTYPES = {"hm": "bfloat16", "wh": "bfloat16", "uv_prior": "bfloat16",
              "theta": "float32"}         # flax's, as jax.eval_shape gives


def csp_rate(card, label, ccfg, dev) -> None:
    """The CSP train step through ``Trainer`` (the user's entry point, on
    the card by default) at batch 8 in bf16: one counted step (no port
    kernel may launch), its loss terms against a float32 forward of the
    same weights on the same batch, TRAIN_WARMUP steps, then TRAIN_ITERS
    timed ones: samples/s, the peak of ``torch.cuda.max_memory_allocated``
    and the device's busy share over 3 profiled steps.

    The bf16 outputs have flax's dtypes (CSP_DTYPES), and with the norms
    frozen lie within BF16_OUT_STEPS bf16 steps of the float32 ones.  Of
    the loss terms, the center focal and size terms are held to
    BF16_LOSS_TOL of the float32 ones; the MANO-theta terms are printed
    beside the smallest decoded depth ``tz`` at the centres: they project
    the hands decoded at random weights, and a ``tz`` near the camera plane
    turns the thetas' gap into a landmark moved by any amount."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.models.csp import csp_from_config
    from pdfnet_tpu_torch.models.layers import BatchNorm
    from pdfnet_tpu_torch.train.mano_branch import csp_loss
    from pdfnet_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(ccfg)
    trainer.init_state()
    host = port.make_batch(ccfg, BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    lr = port.lr_at_epoch(ccfg, 0)
    run = lambda: trainer.train_step(trainer.state, batch, 0, lr)
    models = {}
    for dt in ("bfloat16", "float32"):
        models[dt] = csp_from_config(ccfg.replace(compute_dtype=dt)).to(dev)
        models[dt].load_state_dict(trainer.model.state_dict())
    with torch.no_grad():
        ret32 = models["float32"].train()(batch["input"], batch["depth"])
        _, stats32 = csp_loss(ccfg, trainer.consts, ret32, batch, 0)
        frozen = {}
        for dt, model in models.items():
            jitter_bn_(model, seed=2)
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.frozen = True
            frozen[dt] = model(batch["input"], batch["depth"])
    del models
    outs = []
    hook = trainer.model.register_forward_hook(
        lambda m, i, o: outs.append(o))
    torch.cuda.synchronize()
    reset_port_launches()
    stats = run()
    torch.cuda.synchronize()
    check_launches(f"{label} train step [bf16, batch {BATCH}]", {})
    hook.remove()
    csp_bf16_outputs(label, outs[0], ret32, frozen, batch["ind"])
    gaps = {k: abs(float(stats[k]) - float(v)) / max(abs(float(v)), 1e-6)
            for k, v in stats32.items()}
    print(f"{label} first train step [batch {BATCH}] bf16 against float32 "
          f"on the same weights, relative gap by term: " + ", ".join(
              f"{k} {gaps[k]:.3e} ({float(stats[k]):.6g} / "
              f"{float(stats32[k]):.6g})" for k in sorted(gaps)))
    held = [k for k in ("hm_loss", "wh_loss") if k in gaps]
    check(all(bool(torch.isfinite(v)) for v in stats.values())
          and all(gaps[k] <= BF16_LOSS_TOL for k in held),
          f"{label}: bf16 {', '.join(f'{k} {gaps[k]:.3e}' for k in held)} "
          f"from float32, or a term not finite")
    del outs, ret32, frozen
    params0 = [p.detach().clone() for p in trainer.model.parameters()]
    losses = [stats["loss"]] + [run()["loss"] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        losses.append(run()["loss"])
    torch.cuda.synchronize()
    rate = BATCH * TRAIN_ITERS / (time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu()
    moved = sum(bool((p.detach() != q).any())
                for p, q in zip(trainer.model.parameters(), params0))
    check(bool(torch.isfinite(losses).all()),
          f"{label} train step: a loss is not finite: {losses.tolist()}")
    check(moved > 0.5 * len(params0), f"{label} train step: {moved} of "
          f"{len(params0)} parameters moved")
    print(f"{label} train step [bf16, batch {BATCH}]: losses "
          f"{', '.join(f'{v:.1f}' for v in losses.tolist())}; {moved}/"
          f"{len(params0)} parameters moved")
    print(f"{label} train step samples/s [bf16, batch {BATCH}]: {rate:.2f}; "
          f"peak memory allocated {peak / 2**30:.2f} GiB ({card})")
    check(peak < CARD_MEMORY, f"{label}: peak {peak / 1e9:.1f} GB does not "
          f"fit the card")
    profile(run, f"{ccfg.arch}{'_uv' if ccfg.use_uv_prior else ''}"
            f"_train_bf16_b{BATCH}", steps=3)
    print(f"{label} rate phase: {time.perf_counter() - t0:.1f} s")
    del trainer, batch


def _csp_outputs(ret):
    """``{name: output}`` of a CSP forward, each theta on its own."""
    out = {k: v for k, v in ret.items() if k != "params"}
    out.update({f"theta_{j}": t for j, t in enumerate(ret["params"])})
    return out


def _bf16_gaps(ret, ret32):
    """Per output, the bf16 forward's largest error in bf16 steps at the
    float32 output's largest magnitude, and the error's norm over the
    output's."""
    steps, rel = {}, {}
    for key, want in _csp_outputs(ret32).items():
        diff = _csp_outputs(ret)[key].detach().float() - want
        top = want.abs().max().item()
        steps[key] = diff.abs().max().item() / 2.0 ** (
            math.floor(math.log2(max(top, 1e-30))) - 7)
        rel[key] = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    return steps, rel


def csp_bf16_outputs(label, ret, ret32, frozen, ind) -> None:
    """The bf16 train-mode forward ``ret`` against the float32 one
    ``ret32`` on the same weights and batch, and ``frozen`` (both dtypes
    with every norm on the same running statistics): each bf16 output's
    dtype is flax's (CSP_DTYPES), and the frozen ones lie within
    BF16_OUT_STEPS bf16 steps of float32.  Prints both gaps, and the
    smallest decoded depth ``tz = theta_z + 0.6`` of the last theta at the
    hand centres ``ind`` (B, 2), both ways."""
    import torch

    for r in (ret, frozen["bfloat16"]):
        for key, got in _csp_outputs(r).items():
            want = CSP_DTYPES["theta" if key.startswith("theta") else key]
            check(str(got.dtype) == f"torch.{want}", f"{label}: bf16 {key} "
                  f"is {got.dtype}, flax gives {want}")
    tz = {}
    for tag, r in (("bf16", ret), ("f32", ret32)):
        theta = r["params"][-1].detach().float()
        B, H, W, C = theta.shape
        at = theta.reshape(B, H * W, C)[torch.arange(B)[:, None], ind.long()]
        tz[tag] = torch.stack([at[:, h, 61 * h + 60] for h in (0, 1)],
                              1) + 0.6
    fmt = lambda d, f: ", ".join(f"{k} {v:{f}}" for k, v in d.items())
    steps, rel = _bf16_gaps(frozen["bfloat16"], frozen["float32"])
    print(f"{label} bf16 forward [batch {BATCH}, frozen norms] against "
          f"float32, outputs in flax's dtypes; worst error in bf16 steps: "
          f"{fmt(steps, '.3f')}; error norm / norm: {fmt(rel, '.3e')}")
    bad = max(steps, key=steps.get)
    check(steps[bad] <= BF16_OUT_STEPS, f"{label}: frozen bf16 {bad} lies "
          f"{steps[bad]:.2f} bf16 steps from float32")
    steps, rel = _bf16_gaps(ret, ret32)
    print(f"{label} first train step [batch {BATCH}, batch statistics] "
          f"bf16 outputs against float32: worst error in bf16 steps: "
          f"{fmt(steps, '.3f')}; error norm / norm: {fmt(rel, '.3e')}; "
          f"smallest |tz| at the centres {tz['bf16'].abs().min():.4g} "
          f"(bf16) / {tz['f32'].abs().min():.4g} (f32), largest tz gap "
          f"{(tz['bf16'] - tz['f32']).abs().max():.3e}")


def csp_check(label, ccfg, dev, quirks=(False, True)) -> None:
    """A float32 train-mode forward at batch 2 on the card against the same
    weights on the CPU, then ``csp_loss`` and its gradients with
    ``replicate_reference_quirks`` off and on, on the same forward: every
    output within STEP_TOL of its magnitude, every loss term within
    LOSS_TOL, every gradient within GRAD_TOL of its leaf's largest entry.
    Every BatchNorm normalizes with its (jittered) running statistics, as
    ``train_check_phase``'s do: live statistics of 2 samples at random
    init amplify float32 rounding in the backward far past any bar (the
    CSP detector has no ``freeze_bn_stats``, as in JAX, so the check sets
    the norms' flag itself).  The CPU replays the card's ReLU decisions (an
    activation within rounding of 0 passes on one side only)."""
    import types
    import torch
    import torch.nn.functional as F
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.models import csp, layers, resnet
    from pdfnet_tpu_torch.models.csp import build_csp_model
    from pdfnet_tpu_torch.train.mano_branch import (csp_loss,
                                                    load_mano_branch_consts)

    t0 = time.perf_counter()
    c = ccfg.replace(compute_dtype="float32")
    host = port.make_batch(c, 2, seed=1)
    masks, flips = [], [0, 0]

    def record_relu(x, inplace=False):
        masks.append((x > 0).cpu())
        return F.relu(x)

    def replay_relu(x, inplace=False):
        card = masks.pop(0)
        flips[0] += int(((x > 0) != card).sum())
        flips[1] += card.numel()
        return torch.where(card, x, torch.zeros_like(x))

    def functional(act):
        ns = {n: getattr(F, n) for n in dir(F) if not n.startswith("_")}
        ns.update(relu=act)
        return types.SimpleNamespace(**ns)

    def frozen(d):
        model = build_csp_model(c, device=d).train()
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                m.frozen = True
        return model

    model = frozen(dev)
    jitter_bn_(model, seed=2)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    runs = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        if i:
            model = frozen(d)
            model.load_state_dict(state)
        b = {k: torch.from_numpy(v).to(d) for k, v in host.items()}
        act = functional(replay_relu if i else record_relu)
        ret = run_patched([(m, "F", act) for m in (csp, layers, resnet)],
                          lambda: model(b["input"], b["depth"]))
        consts = load_mano_branch_consts(d)
        params = dict(model.named_parameters())
        side = {"out": {k: v.detach().cpu()
                        for k, v in _csp_outputs(ret).items()}}
        for q in quirks:
            loss, stats = csp_loss(c.replace(replicate_reference_quirks=q),
                                   consts, ret, b, 25)
            names = [n for n in params if params[n].requires_grad]
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        retain_graph=True, allow_unused=True)
            side[q] = ({k: v.detach().cpu() for k, v in stats.items()},
                       {n: g.cpu() for n, g in zip(names, grads)
                        if g is not None})
        runs.append(side)
        del model
    check(not masks, f"{label}: the CPU ran fewer ReLUs than the card")
    print(f"{label} [f32, batch 2]: the CPU's own ReLU decisions differ from "
          f"the card's in {flips[0]} of {flips[1]}; the CPU replays the "
          f"card's")
    compare_steps(f"{label} forward [f32, batch 2]", runs[0]["out"],
                  runs[1]["out"])
    for q in quirks:
        (got_s, got_g), (want_s, want_g) = runs[0][q], runs[1][q]
        tag = f"{label} [f32, batch 2, quirks {'on' if q else 'off'}]"
        worst = 0.0
        for key, w in want_s.items():
            err = (got_s[key] - w).abs().item()
            scale = max(w.abs().item(), 1e-6)
            worst = max(worst, err / scale)
            check(err <= LOSS_TOL * scale, f"{tag}: {key} {got_s[key].item()} "
                  f"on the card, {w.item()} on the CPU")
        check(sorted(got_g) == sorted(want_g),
              f"{tag}: the card and the CPU reach different parameters")
        errs = {}
        for name, w in want_g.items():
            scale = max(w.abs().max().item(), 1e-12)
            errs[name] = ((got_g[name] - w).abs()
                          - GRAD_TOL * w.abs()).max().item() / scale
        bad = sorted(errs, key=errs.get, reverse=True)[:3]
        print(f"{tag} card vs cpu: {len(want_s)} loss terms within "
              f"{LOSS_TOL} (worst {worst:.3e}); {len(errs)} gradients, "
              f"worst error / scale: "
              f"{', '.join(f'{n} {errs[n]:.3e}' for n in bad)}")
        check(errs[bad[0]] <= GRAD_TOL, f"{tag}: gradient of {bad[0]} "
              f"differs by {errs[bad[0]]:.3e} of its scale")
    print(f"{label} float32 check: {time.perf_counter() - t0:.1f} s")


def crop_resize_check(card, dev) -> None:
    """``crop_and_resize`` forward and backward on the card against the CPU
    on boxes inside, across and outside the images, and ms a call."""
    import torch
    from pdfnet_tpu_torch.ops import crop_and_resize

    t0 = time.perf_counter()
    shape, n, crops = CROP_CASES
    gen = torch.Generator().manual_seed(3)
    img = torch.randn(shape, generator=gen)
    lo = torch.rand(n, 2, generator=gen) * 1.2 - 0.3
    boxes = torch.cat([lo, lo + torch.rand(n, 2, generator=gen) * 0.6], 1)
    ind = torch.randint(0, shape[0], (n,), generator=gen, dtype=torch.int32)
    for crop in crops:
        g = torch.randn(n, crop, crop, shape[3], generator=gen)
        res = []
        for d in (dev, torch.device("cpu")):
            x = img.to(d).detach().requires_grad_()
            out = crop_and_resize(x, boxes.to(d), ind.to(d), crop, crop)
            out.backward(g.to(d))
            res.append((out.detach().cpu(), x.grad.cpu()))
        (fo, bo), (fw, bw) = res
        f_err = (fo - fw).abs().max().item() / img.abs().max().item()
        b_err = (bo - bw).abs().max().item() / bw.abs().max().item()
        check(f_err <= CROP_TOL and b_err <= CROP_TOL,
              f"crop_and_resize {crop}x{crop}: card vs CPU forward "
              f"{f_err:.3e}, backward {b_err:.3e} of scale")
        x = img.to(dev).detach().requires_grad_()
        bx, ix, gx = boxes.to(dev), ind.to(dev), g.to(dev)
        fwd = time_ms(lambda: crop_and_resize(x, bx, ix, crop, crop))
        both = time_ms(lambda: crop_and_resize(x, bx, ix, crop, crop)
                       .backward(gx))
        print(f"crop_and_resize {tuple(shape)}, {n} boxes at {crop}x{crop}: "
              f"card vs cpu forward {f_err:.3e}, backward {b_err:.3e} of "
              f"scale (max_abs_err {(fo - fw).abs().max().item():.3e}); "
              f"{fwd:.4f} ms forward, {both:.4f} ms forward + backward "
              f"({card})")
    print(f"crop_and_resize check: {time.perf_counter() - t0:.1f} s")


def csp_phase(card, cfg, dev) -> None:
    """Phase 13: the CSP detector's train step (csp_50, then csp_18 with the
    uv prior) through the trainer, their float32 checks, and
    ``crop_and_resize``."""
    t0 = time.perf_counter()
    for label, kw in CSP_ARCHS:
        ccfg = cfg.replace(**kw)
        csp_rate(card, label, ccfg, dev)
        csp_check(label, ccfg, dev,
                  quirks=(False, True) if kw["arch"] == "csp_50" else (False,))
    crop_resize_check(card, dev)
    print(f"csp phase: {time.perf_counter() - t0:.1f} s")


def csp_cli_phase(tree: str, work: str) -> None:
    """(e) ``cli.main --arch csp_50 --mode train`` for 2 steps on phase 7's
    H2O-format tree (no port kernel launched; no eval, as in JAX), its
    checkpoint restored bit for bit, then ``--mode test --arch csp_50``
    failing, as the JAX CLI does, with ``Trainer.evaluate``'s
    NotImplementedError."""
    import torch
    from pdfnet_tpu_torch.cli.main import main as cli_main
    from pdfnet_tpu_torch.train.trainer import Trainer

    out = os.path.join(work, "out_csp")
    common = ["--arch", "csp_50", "--cache_path", tree, "--pre_fix", tree,
              "--output_path", out, "--batch_size", str(BATCH)]
    t0 = time.perf_counter()
    reset_port_launches()
    trainer = cli_main(["--mode", "train", "--num_epochs", "1", "--steps",
                        "2", "--eval_every", "1", "--save_every", "1"]
                       + common)
    torch.cuda.synchronize()
    check_launches("cli --arch csp_50 --mode train", {})
    check(trainer.state.step == 2 and trainer.eval_step is None,
          "cli csp train: not 2 steps, or an eval step")
    ckpt = os.path.join(out, "ckpt", "default", "model_0")
    saved = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    restored = Trainer(trainer.cfg)
    restored.init_state(seed=5)
    restored.load(ckpt)
    got = restored.model.state_dict()
    check(sorted(got) == sorted(saved) and all(
        torch.equal(got[k].cpu(), saved[k]) for k in saved),
        "cli csp train: the checkpoint does not restore bit for bit")
    del trainer, restored
    try:
        cli_main(["--mode", "test", "--load_model", ckpt] + common)
        check(False, "cli --mode test --arch csp_50 did not raise")
    except NotImplementedError as e:
        check("mesh evaluation is only defined for the flagship HandNet"
              in str(e), f"cli csp test: unexpected message {e}")
        print(f"cli --mode test --arch csp_50: NotImplementedError, as in "
              f"JAX: {e}")
    print(f"cli --arch csp_50: 2 train steps, checkpoint restored bit for "
          f"bit; {time.perf_counter() - t0:.1f} s")


# ---- phase 14 (run after phase 13): data-parallel training ------------------

DIST_STEPS = 3
DIST_LAUNCHES = {"knn_group_xyz": DIST_STEPS, "group_feat": DIST_STEPS}
# (b)'s bounds of tests/test_torch_parallel.py: each loss term relative to
# its one-process value, each first-step gradient relative to its leaf's
# norm; each parameter's move over the 3 steps relative to its norm (on the
# entries of well-defined sign), in place of the elementwise rule, which
# bf16 and the card's atomic sums break between two runs without a group
DIST_LOSS_RTOL = 1e-5
DIST_GRAD_RTOL = 1e-4
DIST_MOVE_RTOL = 1e-3
DIST_SPREAD = 4.0       # x the gap between two runs without a group
DIST_GAPS = []          # that gap (dist_gaps), for the CLI part
DIST_WARMUP, DIST_ITERS = 2, 6


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_steps(cfg, batches, zero1: bool):
    """``Trainer`` (the card) over ``batches``, one step each: every step's
    stats on the host, the parameters before and after, the trainer."""
    import torch
    from pdfnet_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg.replace(zero1_opt_sharding=zero1))
    trainer.init_state()
    before = [p.detach().clone() for p in trainer.model.parameters()]
    gen = torch.Generator(device=trainer.device)
    stats, grads = [], None
    for i, b in enumerate(batches):
        gen.manual_seed(i)
        s = trainer.train_step(trainer.state, b, 0, 1e-4, gen)
        stats.append({k: float(v) for k, v in s.items()})
        if grads is None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for p in trainer.model.parameters()]
    after = [p.detach().clone() for p in trainer.model.parameters()]
    return [stats, before, after, grads, trainer]


def dist_gaps(got, want):
    """(the largest loss-term gap relative to the term, over the steps; the
    first-step gradients' gap relative to their norm, all leaves as one
    vector; likewise the parameters' moves over the steps, on the entries
    whose first-step gradient exceeds 1e-3 of its leaf's largest: Adam
    moves the others by the sign of float32 noise)."""
    s_got, b_got, a_got, g_got = got[:4]
    s_want, b_want, a_want, g_want = want[:4]
    loss = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-8)
               for g, w in zip(s_got, s_want) for k in w)
    norm = lambda ts: math.sqrt(sum(float(t.float().norm()) ** 2 for t in ts))
    grad = norm(gg - gw for gg, gw in zip(g_got, g_want)) / max(
        norm(g_want), 1e-30)
    held = [gw.abs() > 1e-3 * gw.abs().max() for gw in g_want]
    moves_w = [(aw - bw)[h] for aw, bw, h in zip(a_want, b_want, held)]
    moves_g = [(ag - bg)[h] for ag, bg, h in zip(a_got, b_got, held)]
    move = norm(mg - mw for mg, mw in zip(moves_g, moves_w)) / max(
        norm(moves_w), 1e-30)
    return loss, grad, move


def dist_phase(card, cfg, dev) -> dict:
    """Phase 14: the data-parallel train step on a one-rank NCCL group
    against the same steps without a group.  Returns the launches of its
    counted runs."""
    import torch
    import torch.distributed as dist
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    check(not mesh.is_distributed(), "a process group before phase 14")
    host = [port.make_batch(cfg, BATCH, seed=s) for s in range(DIST_STEPS)]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in h.items()}
               for h in host]
    ref = dist_steps(cfg, batches, False)[:4]
    ref2 = dist_steps(cfg, batches, False)[:4]
    spread = dist_gaps(ref2, ref)
    del ref2
    DIST_GAPS[:] = spread
    print(f"dist: two runs without a group [bf16, batch {BATCH}, "
          f"{DIST_STEPS} steps]: loss terms {spread[0]:.3e}, first "
          f"gradients {spread[1]:.3e}, parameter moves {spread[2]:.3e} "
          f"apart (the card's run-to-run spread)")
    multi = mesh.maybe_initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    check(not multi and mesh.is_distributed() and mesh.process_count() == 1
          and dist.get_backend() == ("nccl" if dev.type == "cuda"
                                     else "gloo"),
          "dist: no one-rank NCCL group")
    launches = {n: 0 for n in DIST_LAUNCHES}
    try:
        for zero1 in (False, True):
            label = f"dist {'zero1' if zero1 else 'replicated'}"
            reset_port_launches()
            got = dist_steps(cfg, batches, zero1)
            torch.cuda.synchronize()
            for n, v in check_launches(f"{label} [{DIST_STEPS} steps]",
                                       DIST_LAUNCHES).items():
                if n in launches:
                    launches[n] += v
            trainer = got[4]
            check(type(trainer.state.optimizer).__name__
                  == ("Zero1Adam" if zero1 else "Adam"),
                  f"{label}: optimizer {type(trainer.state.optimizer)}")
            gaps = dist_gaps(got, ref)
            bounds = [max(b, DIST_SPREAD * g) for b, g in zip(
                (DIST_LOSS_RTOL, DIST_GRAD_RTOL, DIST_MOVE_RTOL), spread)]
            print(f"{label} against no group [bf16, batch {BATCH}, "
                  f"{DIST_STEPS} steps]: loss terms {gaps[0]:.3e} (bound "
                  f"{bounds[0]:.3e}), first gradients {gaps[1]:.3e} (bound "
                  f"{bounds[1]:.3e}), parameter moves {gaps[2]:.3e} (bound "
                  f"{bounds[2]:.3e})")
            check(all(g <= b for g, b in zip(gaps, bounds)),
                  f"{label}: {gaps} beyond {bounds}")
            run = lambda: trainer.train_step(trainer.state, batches[0], 0,
                                             1e-4)
            for _ in range(DIST_WARMUP):
                run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            for _ in range(DIST_ITERS):
                run()
            torch.cuda.synchronize()
            rate = BATCH * DIST_ITERS / (time.perf_counter() - t1)
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"{label} train step samples/s [bf16, batch {BATCH}]: "
                  f"{rate:.2f}; peak memory allocated {peak / 2**30:.2f} GiB "
                  f"({card})")
            if not zero1:
                params = list(trainer.model.parameters())
                n = sum(p.numel() for p in params if p.grad is not None)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                mesh.all_reduce_grads(params)
                start.record()
                for _ in range(10):
                    mesh.all_reduce_grads(params)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 10
                print(f"dist gradient all-reduce [one rank, {n} float32 "
                      f"gradients, {4 * n / 2**20:.1f} MiB]: {ms:.4f} ms "
                      f"({card})")
            busy = profile(run, f"dist_{'zero1' if zero1 else 'rep'}_train_"
                           f"bf16_b{BATCH}", steps=3)
            print(f"{label} train step device busy share [bf16, batch "
                  f"{BATCH}, 3 profiled steps]: {busy:.3f} ({card})")
            del trainer, got, run
        dist_fit(cfg)
    finally:
        dist.destroy_process_group()
    print(f"dist phase: {time.perf_counter() - t0:.1f} s")
    return launches


def dist_fit(cfg) -> None:
    """``fit`` for 2 steps in the group with ZeRO-1 on the synthetic hands:
    its collective save writes the one-process format."""
    import shutil

    import torch
    from pdfnet_tpu_torch.data.synthetic import SyntheticHandDataset
    from pdfnet_tpu_torch.train.trainer import fit

    work = os.path.join(OUT_DIR, "dist_fit")
    shutil.rmtree(work, ignore_errors=True)
    c = cfg.replace(zero1_opt_sharding=True, num_epochs=1, batch_size=BATCH)
    trainer = fit(c, SyntheticHandDataset(c, size=2 * BATCH), None,
                  log_dir=os.path.join(work, "logs"),
                  ckpt_dir=os.path.join(work, "ckpt"), eval_every=0,
                  save_every=1, max_steps_per_epoch=2)
    saved = torch.load(os.path.join(work, "ckpt", "model_0"),
                       map_location="cpu", weights_only=True)
    params = dict(trainer.model.named_parameters())
    state = saved["opt_state"]["state"]
    check(saved["step"] == 2 and sorted(saved["params"]) == sorted(params)
          and all(torch.equal(saved["params"][n], p.detach().cpu())
                  for n, p in params.items())
          and all(state[i]["exp_avg"].shape == p.shape
                  for i, p in enumerate(params.values()) if i in state),
          "dist fit: the checkpoint is not the one-process format of the "
          "trainer's state")
    print("dist fit [ZeRO-1, 2 steps]: checkpoint in the one-process "
          "format, parameters bit for bit, full-shape moments")
    shutil.rmtree(work, ignore_errors=True)


def dist_cli_phase(tree: str, work: str, spread) -> None:
    """``cli.main --mode train --coordinator 127.0.0.1:<port>
    --num_processes 1 --process_id 0`` for 2 steps on phase 7's tree, then
    the same command without the flags: the checkpoints' moves and first
    moments within the bounds of phase 14."""
    import torch
    from pdfnet_tpu_torch.cli.main import main as cli_main
    from pdfnet_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    ckpts = []
    for flags in (["--coordinator", f"127.0.0.1:{free_port()}",
                   "--num_processes", "1", "--process_id", "0"], []):
        out = os.path.join(work, f"out_dist{len(ckpts)}")
        reset_port_launches()
        cli_main(["--mode", "train", "--num_epochs", "1", "--steps", "2",
                  "--eval_every", "0", "--save_every", "1", "--cache_path",
                  tree, "--pre_fix", tree, "--output_path", out,
                  "--batch_size", str(BATCH)] + flags)
        torch.cuda.synchronize()
        check_launches(f"cli --mode train {' '.join(flags[:1])}",
                       {"knn_group_xyz": 2, "group_feat": 2})
        check(not mesh.is_distributed(), "cli: the group outlived main")
        ckpts.append(torch.load(os.path.join(out, "ckpt", "default",
                                             "model_0"),
                                map_location="cpu", weights_only=True))
    got, want = ckpts
    check(got["step"] == want["step"] == 2
          and sorted(got["params"]) == sorted(want["params"]),
          "cli --coordinator: checkpoint structure differs")
    # the first moments (two steps' gradients) as one vector, as dist_gaps
    # holds the gradients
    sq = lambda ts: sum(float(t.norm()) ** 2 for t in ts)
    state_g, state_w = (c["opt_state"]["state"] for c in (got, want))
    moments = math.sqrt(sq(state_g[i]["exp_avg"] - s["exp_avg"]
                           for i, s in state_w.items())
                        / max(sq(s["exp_avg"] for s in state_w.values()),
                              1e-30))
    bound = max(DIST_GRAD_RTOL, DIST_SPREAD * spread[1])
    print(f"cli --coordinator (one rank) against no flags [bf16, batch "
          f"{BATCH}, 2 steps]: first moments {moments:.3e} apart (bound "
          f"{bound:.3e}); {time.perf_counter() - t0:.1f} s")
    check(moments <= bound, f"cli --coordinator: moments {moments:.3e} "
          f"apart, beyond {bound:.3e}")


# no dropout: the loader stripes records by rank, so the global batch is
# the ranks' stripes in rank order, another order of the same records than
# one process's batch, and a dropout mask row would meet another sample
RANKS_ARGS = ["--mode", "train", "--synthetic", "--batch_size", str(BATCH),
              "--num_epochs", "1", "--steps", "3", "--eval_every", "1",
              "--save_every", "1", "--compute_dtype", "float32",
              "--freeze_bn_stats", "--dropout", "0", "--lr", "1e-7"]


def run_cli_processes(argvs, timeout=900):
    """``python -m pdfnet_tpu_torch.cli.main`` once for each argv, all
    started together; their outputs, after every one has exited (each is
    killed at ``timeout``).  The CLI sets TF32 off itself (cuDNN's default
    would run the float32 convolutions in TF32, by other algorithms at
    batch 2 than at 8), so the ``--ranks`` checks hold its own setting."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m",
                               "pdfnet_tpu_torch.cli.main", *argv],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for argv, p, out in zip(argvs, procs, outs):
        check(p.returncode == 0, f"cli {' '.join(argv)} exited "
              f"{p.returncode}:\n{out[-4000:]}")
    return outs


def ranks_phase(card, n: int, extra=()) -> None:
    """``--ranks N``: the train CLI in N processes joined by
    ``--coordinator`` (NCCL, one card each; gloo under ``--cpu`` in
    ``extra``) against one process on the same global batches."""
    import glob
    import shutil

    import numpy as np
    import torch

    work = os.path.join(OUT_DIR, f"ranks{n}")
    shutil.rmtree(work, ignore_errors=True)
    args = RANKS_ARGS + list(extra)
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    outs = run_cli_processes([
        args + ["--output_path", os.path.join(work, f"rank{i}"),
                "--coordinator", coord, "--num_processes", str(n),
                "--process_id", str(i)] for i in range(n)])
    wall = time.perf_counter() - t0
    check(f"multi-host: process 0 of {n}" in outs[0],
          f"ranks: rank 0 did not join a group of {n}:\n{outs[0][-2000:]}")
    check(not any(os.path.exists(os.path.join(work, f"rank{i}"))
                  for i in range(1, n)), "ranks: a rank other than 0 wrote")
    t1 = time.perf_counter()
    run_cli_processes([args + ["--output_path", os.path.join(work, "one")]])
    print(f"ranks: {n} processes {wall:.1f} s, one process "
          f"{time.perf_counter() - t1:.1f} s (3 steps, an eval, a save; "
          f"process start-up included)")

    def read(d):
        logs = glob.glob(os.path.join(d, "logs", "**", "log.jsonl"),
                         recursive=True)
        vals = glob.glob(os.path.join(d, "logs", "**", "H2O-val.txt"),
                         recursive=True)
        check(len(logs) == len(vals) == 1, f"ranks: logs under {d}")
        with open(logs[0]) as f:
            loss = json.loads(f.readline())["loss"]
        with open(vals[0]) as f:
            scores = [float(line.split(": ")[1]) for line in f
                      if ": " in line]
        ckpt = torch.load(os.path.join(d, "ckpt", "default", "model_0"),
                          map_location="cpu", weights_only=True)
        return loss, scores, ckpt

    (l_n, s_n, c_n), (l_1, s_1, c_1) = (read(os.path.join(work, d))
                                        for d in ("rank0", "one"))
    loss_gap = abs(l_n - l_1) / abs(l_1)
    score_gap = float(np.max(np.abs(np.subtract(s_n, s_1))
                             / np.maximum(np.abs(s_1), 1e-12)))
    sq = lambda ts: sum(float(t.double().norm()) ** 2 for t in ts)
    st_n, st_1 = c_n["opt_state"]["state"], c_1["opt_state"]["state"]
    check(sorted(st_n) == sorted(st_1) and c_n["step"] == c_1["step"] == 3,
          "ranks: checkpoints of different steps or moments")
    names = list(c_1["params"])
    gap = lambda keep: math.sqrt(
        sq(st_n[i]["exp_avg"] - s["exp_avg"] for i, s in st_1.items()
           if keep(names[i]))
        / sq(s["exp_avg"] for i, s in st_1.items() if keep(names[i])))
    # without the leaves whose gradients cancel (the attention key biases,
    # the level-0 SFT of the raw clouds: tests/test_torch_parallel.py's
    # CANCELLING), which float32 order alone moves by up to their norm
    moments = gap(lambda n: not (n.endswith("wk.bias")
                                 or "pointnet.sft0." in n))
    print(f"ranks: {n} processes against one [float32, global batch "
          f"{BATCH}, frozen BatchNorm, 3 steps]: first loss {loss_gap:.3e} "
          f"(bound 1e-5), merged scores {score_gap:.3e} (1e-4), first "
          f"moments {moments:.3e} (1e-2; {gap(lambda n: True):.3e} with "
          f"the cancelling leaves) apart ({card})")
    check(len(s_n) == len(s_1) == 8 and loss_gap <= 1e-5
          and score_gap <= 1e-4 and moments <= 1e-2,
          f"ranks: {n} processes differ from one")
    shutil.rmtree(work, ignore_errors=True)


# ---- phase 15 (run after phase 14): the 2-D (data x model) layout -----------

TP_STEPS = 3
TP_TRAIN_LAUNCHES = {"knn_group_xyz": TP_STEPS, "group_feat": TP_STEPS}
TP_EVAL_LAUNCHES = {"sa_group_l1": 1, "sa_group_l2": 1, "sa_mlp_max": 2}
TP_SERVE_LAUNCHES = {"knn": 2, "fused_bottleneck_s1": 8}
TP_WARMUP, TP_ITERS = 2, 6


class CollectiveCount:
    """Counts the process group's collectives (all_gather, all_reduce,
    broadcast) while active: ``torch.distributed``'s functions wrapped."""

    KINDS = ("all_gather", "all_reduce", "broadcast")

    def __enter__(self):
        import torch.distributed as dist
        self.counts = {k: 0 for k in self.KINDS}
        self.saved = {k: getattr(dist, k) for k in self.KINDS}
        for k, fn in self.saved.items():
            def counted(*a, _k=k, _fn=fn, **kw):
                self.counts[_k] += 1
                return _fn(*a, **kw)
            setattr(dist, k, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for k, fn in self.saved.items():
            setattr(dist, k, fn)


def hand_sized_(model) -> None:
    """The vertex offsets' head scaled by 0.01 (tests/test_torch_ranks.py's
    ``seeded_state``): at the initializers' scale the decoded hands lie
    near the camera plane, where the 2-D terms amplify float32 noise."""
    import torch
    with torch.no_grad():
        for p in model.decoder.coord_head.parameters():
            p.mul_(0.01)


def tp_model(cfg, dev, layout, seed_bn=None, state=None, hands=False):
    """``build_model(cfg)`` (seeded; ``hand_sized_`` with ``hands``), its
    BatchNorm statistics jittered with ``seed_bn`` or its weights
    ``state``, split over ``layout`` when given."""
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.parallel import mesh
    model = port.build_model(cfg, device=dev)
    if hands:
        hand_sized_(model)
    if seed_bn is not None:
        jitter_bn_(model, seed=seed_bn)
    if state is not None:
        model.load_state_dict(state)
    if layout is not None:
        mesh.shard_params_tp(model, layout)
    return model


def tp_train_steps(cfg, batches, dev, layout, lr=1e-4, hands=False):
    """``TP_STEPS`` train steps at ``lr`` of the seeded model
    (``hand_sized_`` with ``hands``; split over ``layout`` when given), one
    a batch, dropout from a generator seeded by the step: [every step's
    stats on the host, the parameters before and after and the first
    step's gradients (whole, in the unsplit order), the state, the step,
    the parameter names, the split plan]."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.parallel import mesh
    model = port.build_model(cfg, device=dev)
    if hands:
        hand_sized_(model)
    names = [n for n, _ in model.named_parameters()]
    before = [p.detach().clone() for p in model.parameters()]
    plan = {} if layout is None else mesh.shard_params_tp(model, layout)
    state = port.create_train_state(cfg, model)
    step = port.make_train_step(cfg, model, port.load_loss_consts(dev))
    gen = torch.Generator(device=dev)

    def whole(tensors):
        out = {mesh.plain_name(n): mesh.unshard(model, n, t)
               for n, t in tensors}
        return [out[n] for n in names]

    stats, grads = [], None
    for i, b in enumerate(batches):
        gen.manual_seed(i)
        s = step(state, b, 0, lr, gen)
        stats.append({k: float(v) for k, v in s.items()})
        if grads is None:
            grads = whole((n, torch.zeros_like(p) if p.grad is None
                           else p.grad) for n, p in model.named_parameters())
    after = [t.clone() for t in whole((n, p.detach())
                                      for n, p in model.named_parameters())]
    return [stats, before, after, grads, state, step, names, plan]


def outputs_gap(got, want) -> float:
    """The largest output gap relative to that output's largest entry."""
    return max(float((got[k].float() - want[k].float()).abs().max())
               / max(float(want[k].float().abs().max()), 1e-30)
               for k in want)


def tp_phase(card, cfg, dev) -> dict:
    """Phase 15: the train, eval and serving steps with the model split by
    ``shard_params_tp`` over ``make_mesh_2d(1, 1)`` on a one-rank NCCL
    group (every split leaf a whole slice; the column-parallel and gather
    code and its NCCL calls run), against the same steps without a group.
    Returns the launches of its counted runs."""
    import torch
    import torch.distributed as dist
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    check(not mesh.is_distributed(), "a process group before phase 15")
    host = [port.make_batch(cfg, BATCH, seed=s) for s in range(TP_STEPS)]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in h.items()}
               for h in host]
    res, n = cfg.default_resolution, cfg.sample_num
    ebatch = {k: torch.from_numpy(v).to(dev)
              for k, v in bench_batch(BATCH, res, n).items()}
    scfg = cfg.replace(knn_method="pallas", fused_trunk=True)
    consts = port.load_loss_consts(dev)

    # the runs without a group (twice for the train step: the card's own
    # run-to-run spread, phase 14's rule)
    ref = tp_train_steps(cfg, batches, dev, None)
    spread = dist_gaps(tp_train_steps(cfg, batches, dev, None)[:4], ref[:4])
    print(f"tp: two train runs without a group [bf16, batch {BATCH}, "
          f"{TP_STEPS} steps]: loss terms {spread[0]:.3e}, first gradients "
          f"{spread[1]:.3e}, parameter moves {spread[2]:.3e} apart")
    ref_rate = tp_rate(ref, batches[0])
    emodel = tp_model(cfg, dev, None, seed_bn=1)
    estep = port.make_eval_step(cfg, emodel, consts)
    eref, eref2 = estep(ebatch), estep(ebatch)
    e_rate = fps(estep, ebatch, BATCH)
    smodel = tp_model(scfg, dev, None, seed_bn=3)
    split_masks_(smodel, ebatch["input"])
    sstate = smodel.state_dict()
    # each serving run samples its clouds from a generator seeded alike
    serve_once = lambda m: make_serve_step(   # noqa: E731
        scfg, m, consts, torch.Generator(device=dev).manual_seed(0))(
        ebatch)[0]
    sref, sref2 = serve_once(smodel), serve_once(smodel)
    sstep = make_serve_step(scfg, smodel, consts,
                            torch.Generator(device=dev).manual_seed(0))
    s_rate = fps(lambda b: sstep(b)[0], ebatch, BATCH)
    ref[4:6] = [None, None]
    del emodel, estep, smodel, sstep

    multi = mesh.maybe_initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    check(not multi and mesh.is_distributed()
          and dist.get_backend() == ("nccl" if dev.type == "cuda"
                                     else "gloo"),
          "tp: no one-rank NCCL group")
    launches = {}
    try:
        layout = mesh.make_mesh_2d(1, 1)
        check((layout.data, layout.model) == (1, 1), f"tp: {layout}")

        # the train step, counted
        reset_port_launches()
        got = tp_train_steps(cfg, batches, dev, layout)
        torch.cuda.synchronize()
        launches.update(check_launches(f"tp train [{TP_STEPS} steps]",
                                       TP_TRAIN_LAUNCHES))
        state = got[4]
        plan = got[7]
        full = dict(zip(got[6], (t.shape for t in got[1])))
        stored = {mesh.plain_name(n): p.shape
                  for n, p in state.model.named_parameters()}
        check(len(plan) > 100 and len(mesh.shard_tensors(state.model))
              == len(plan) and all(stored[n] == full[n] for n in plan),
              "tp: the split leaves are not whole slices at model axis 1")
        gaps = dist_gaps(got[:4], ref[:4])
        bit = all(g == 0 for g in gaps)
        bounds = [max(b, DIST_SPREAD * g) for b, g in zip(
            (DIST_LOSS_RTOL, DIST_GRAD_RTOL, DIST_MOVE_RTOL), spread)]
        print(f"tp train (1 x 1) against no group [bf16, batch {BATCH}, "
              f"{TP_STEPS} steps]: loss terms {gaps[0]:.3e} (bound "
              f"{bounds[0]:.3e}), first gradients {gaps[1]:.3e} (bound "
              f"{bounds[1]:.3e}), parameter moves {gaps[2]:.3e} (bound "
              f"{bounds[2]:.3e}){'; bit for bit' if bit else ''}")
        check(all(g <= b for g, b in zip(gaps, bounds)),
              f"tp train: {gaps} beyond {bounds}")
        with CollectiveCount() as cc:
            got[5](state, batches[0], 0, 1e-4)
            torch.cuda.synchronize()
        print(f"tp train step NCCL calls a step: {json.dumps(cc.counts)}")
        rate, peak = tp_rate(got, batches[0])
        busy = profile(lambda: got[5](state, batches[0], 0, 1e-4),
                       f"tp_train_bf16_b{BATCH}", steps=3)
        print(f"tp train step samples/s [bf16, batch {BATCH}]: {rate:.2f} "
              f"(without a group {ref_rate[0]:.2f}); peak memory allocated "
              f"{peak / 2**30:.2f} GiB (without {ref_rate[1] / 2**30:.2f}); "
              f"busy {busy:.3f} ({card})")
        del got, state, ref

        # the eval step, counted
        emodel = tp_model(cfg, dev, layout, seed_bn=1)
        estep = port.make_eval_step(cfg, emodel, consts)
        reset_port_launches()
        eout = estep(ebatch)
        torch.cuda.synchronize()
        for k, v in check_launches("tp eval step", TP_EVAL_LAUNCHES).items():
            launches[k] = launches.get(k, 0) + v
        check_outputs("tp eval", eout, BATCH)
        gap, own = outputs_gap(eout, eref), outputs_gap(eref2, eref)
        bound = max(DIST_LOSS_RTOL, DIST_SPREAD * own)
        print(f"tp eval (1 x 1) against no group [bf16, batch {BATCH}]: "
              f"outputs {gap:.3e} of their scale apart (bound {bound:.3e}; "
              f"two runs without a group {own:.3e})"
              f"{'; bit for bit' if gap == 0 else ''}")
        check(gap <= bound, f"tp eval: {gap:.3e} beyond {bound:.3e}")
        with CollectiveCount() as cc:
            estep(ebatch)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        rate = fps(estep, ebatch, BATCH)
        peak = torch.cuda.max_memory_allocated(dev)
        busy = profile(lambda: estep(ebatch), f"tp_eval_bf16_b{BATCH}",
                       steps=3)
        print(f"tp eval step frames/s [bf16, batch {BATCH}]: {rate:.2f} "
              f"(without a group {e_rate:.2f}); peak {peak / 2**30:.2f} "
              f"GiB; busy {busy:.3f}; NCCL calls a step "
              f"{json.dumps(cc.counts)} ({card})")
        del emodel, estep

        # the serving step, counted
        smodel = tp_model(scfg, dev, layout, state=sstate)
        reset_port_launches()
        sout = serve_once(smodel)
        torch.cuda.synchronize()
        for k, v in check_launches("tp serve step",
                                   TP_SERVE_LAUNCHES).items():
            launches[k] = launches.get(k, 0) + v
        check_outputs("tp serve", sout, BATCH)
        gap, own = outputs_gap(sout, sref), outputs_gap(sref2, sref)
        bound = max(DIST_LOSS_RTOL, DIST_SPREAD * own)
        print(f"tp serve (1 x 1) against no group [bf16, batch {BATCH}]: "
              f"outputs {gap:.3e} of their scale apart (bound {bound:.3e}; "
              f"two runs without a group {own:.3e})"
              f"{'; bit for bit' if gap == 0 else ''}")
        check(gap <= bound, f"tp serve: {gap:.3e} beyond {bound:.3e}")
        sstep = make_serve_step(scfg, smodel, consts,
                                torch.Generator(device=dev).manual_seed(0))
        with CollectiveCount() as cc:
            sstep(ebatch)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        rate = fps(lambda b: sstep(b)[0], ebatch, BATCH)
        peak = torch.cuda.max_memory_allocated(dev)
        busy = profile(lambda: sstep(ebatch), f"tp_serve_bf16_b{BATCH}",
                       steps=3)
        print(f"tp serve step frames/s [bf16, batch {BATCH}]: {rate:.2f} "
              f"(without a group {s_rate:.2f}); peak {peak / 2**30:.2f} "
              f"GiB; busy {busy:.3f}; NCCL calls a step "
              f"{json.dumps(cc.counts)} ({card})")
        del smodel, sstep
    finally:
        dist.destroy_process_group()
    print(f"tp phase: {time.perf_counter() - t0:.1f} s")
    return launches


def tp_rate(run, batch):
    """(samples/s of ``TP_ITERS`` steps after ``TP_WARMUP`` of the train
    state and step in ``run``, the peak memory allocated meanwhile)."""
    import torch
    state, step = run[4], run[5]
    for _ in range(TP_WARMUP):
        step(state, batch, 0, 1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TP_ITERS):
        step(state, batch, 0, 1e-4)
    torch.cuda.synchronize()
    return (BATCH * TP_ITERS / (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated())


# ``--ranks 4``: the (2 data x 2 model) steps in 4 NCCL processes against one
TP_RANKS_CFG = dict(compute_dtype="float32", freeze_bn_stats=True,
                    dropout=0.0)
# tests/test_torch_parallel.py's bounds for one step (assert_within_spread):
# each first-step loss term 1e-5 relative, the first gradients as one
# vector 1e-3 of its norm (GRAD_RTOL "handnet") and each leaf 5e-2
# (MOMENT_RTOL; the cancelling leaves left out), or 4x the one process's
# run-to-run gap; the later steps' loss terms within LOSS_TOL
TP_RANKS_GRAD, TP_RANKS_LEAF = 1e-3, 5e-2
# tests/test_torch_tp.py's EVAL_TOL, relative to each output's largest entry
TP_RANKS_EVAL = 1e-4
# as RANKS_ARGS: at 1e-4 Adam's first step turns float32 sign noise in
# gradients near zero into 2 lr moves that the next steps' losses feel
TP_RANKS_LR = 1e-7
CANCELLING = ("wk.bias", "pointnet.sft0.")


def tp_rank_main(rank: int, coordinator: str, out: str,
                 device: str = "cuda") -> int:
    """One rank of ``--ranks 4``'s 2-D run (``--tp_rank``): the (2 x 2)
    layout over 4 NCCL processes, ``TP_STEPS`` float32 train steps of its
    data stripe of the global batches of ``BATCH``, then the eval step on
    its stripe; writes its results to ``out``."""
    import torch
    import torch.distributed as dist
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.parallel import mesh
    mesh.maybe_initialize_distributed(coordinator, 4, rank, device=device)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    layout = mesh.make_mesh_2d(2, 2)
    cfg = port.Config(**TP_RANKS_CFG)
    rows = slice(layout.data_index * BATCH // 2,
                 (layout.data_index + 1) * BATCH // 2)
    batches = [{k: torch.from_numpy(v[rows]).to(dev) for k, v in
                port.make_batch(cfg, BATCH, seed=s).items()}
               for s in range(TP_STEPS)]
    # the first step's replicated gradients as the rank computed them,
    # before ``mesh.sync_model_peers`` averages them over the model group
    pre, sync = [], mesh.sync_model_peers

    def recording(model, lay, stats):
        if not pre:
            shards = {id(t) for t in mesh.shard_tensors(model)}
            pre.append({n: p.grad.detach().cpu().clone()
                        for n, p in model.named_parameters()
                        if id(p) not in shards and p.grad is not None})
        sync(model, lay, stats)

    mesh.sync_model_peers = recording
    try:
        run = tp_train_steps(cfg, batches, dev, layout, TP_RANKS_LR, True)
    finally:
        mesh.sync_model_peers = sync
    res, n = cfg.default_resolution, cfg.sample_num
    ebatch = {k: torch.from_numpy(v[rows]).to(dev)
              for k, v in bench_batch(BATCH, res, n).items()}
    emodel = tp_model(cfg, dev, layout, seed_bn=1, hands=True)
    eout = port.make_eval_step(cfg, emodel, port.load_loss_consts(dev))(
        ebatch)
    torch.save({"stats": run[0], "grads": [g.cpu() for g in run[3]],
                "after": [a.cpu() for a in run[2]], "names": run[6],
                "eval": {k: v.cpu() for k, v in eout.items()},
                "pre_sync": pre[0], "data_index": layout.data_index}, out)
    dist.destroy_process_group()
    return 0


def run_tp_ranks(outs) -> None:
    """``chip_smoke.py --tp_rank i`` for the 4 ranks, all started together
    (TF32 off, as in this script), each writing ``outs[i]``."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, NVIDIA_TF32_OVERRIDE="0")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO,
                                                            "chip_smoke.py"),
                               "--tp_rank", str(i), "--coordinator", coord,
                               "--out", outs[i]], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(len(outs))]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"tp rank {i} exited {p.returncode}:\n"
              f"{log[-4000:]}")


def rel(got: dict, want: dict) -> float:
    """The largest gap of ``got``'s values to ``want``'s, relative to
    each."""
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
               for k in want)


def tp_ranks_phase(card, dev) -> None:
    """``--ranks 4``: the (2 x 2) train and eval steps in 4 NCCL processes
    (one card each) against one process on ``dev`` on the same global
    batches."""
    import shutil

    import torch
    import pdfnet_tpu_torch as port

    work = os.path.join(OUT_DIR, "tp_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = port.Config(**TP_RANKS_CFG)
    t0 = time.perf_counter()
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                port.make_batch(cfg, BATCH, seed=s).items()}
               for s in range(TP_STEPS)]
    want = tp_train_steps(cfg, batches, dev, None, TP_RANKS_LR, True)
    alt = tp_train_steps(cfg, batches, dev, None, TP_RANKS_LR, True)
    res, n = cfg.default_resolution, cfg.sample_num
    ebatch = {k: torch.from_numpy(v).to(dev)
              for k, v in bench_batch(BATCH, res, n).items()}
    emodel = tp_model(cfg, dev, None, seed_bn=1, hands=True)
    eref = port.make_eval_step(cfg, emodel, port.load_loss_consts(dev))(
        ebatch)
    eref = {k: v.cpu() for k, v in eref.items()}
    want[4:6] = alt[4:6] = [None, None]     # the states and steps
    del emodel
    one = time.perf_counter() - t0
    outs = [os.path.join(work, f"rank{i}.pt") for i in range(4)]
    t1 = time.perf_counter()
    try:
        run_tp_ranks(outs)
        got = [torch.load(o, map_location="cpu", weights_only=True)
               for o in outs]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"tp ranks: 4 processes {time.perf_counter() - t1:.1f} s, one "
          f"process (two runs and the eval) {one:.1f} s")
    names = got[0]["names"]
    check(names == want[6], "tp ranks: the parameter order differs")
    sq = lambda ts: sum(float(t.double().norm()) ** 2 for t in ts)
    keep = [i for i, n in enumerate(names)
            if not any(c in n for c in CANCELLING)]
    w_g = [want[3][i].cpu() for i in keep]
    vec = lambda gs: math.sqrt(sq(g - w for g, w in zip(gs, w_g))
                               / max(sq(w_g), 1e-30))
    g_vec = vec([got[0]["grads"][i] for i in keep])
    a_vec = vec([alt[3][i].cpu() for i in keep])
    # the model peers of each data rank: their loss terms (computed before
    # their replicated gradients are averaged over the model group), their
    # first replicated gradients before that average (apart only by the
    # card's float32 atomics: within the one process's own run-to-run gap,
    # the bound of phase 14), their parameters and gradients after it
    pairs = ((got[0], got[1]), (got[2], got[3]))
    peer_loss = max(rel(a["stats"][i], b["stats"][i]) for a, b in pairs
                    for i in range(TP_STEPS))
    rep = [n for n in got[0]["pre_sync"]
           if not any(c in n for c in CANCELLING)]
    pre_gap = max(math.sqrt(sq(a["pre_sync"][n] - b["pre_sync"][n]
                               for n in rep)
                            / max(sq(a["pre_sync"][n] for n in rep), 1e-30))
                  for a, b in pairs)
    pre_bound = max(DIST_GRAD_RTOL, DIST_SPREAD * a_vec)
    peers = [max(float((x - y).abs().max()) for x, y in zip(a[k], b[k]))
             for k in ("after", "grads") for a, b in pairs]
    print(f"tp ranks: model peers' loss terms {peer_loss:.3e} apart (bound "
          f"0), their first {len(rep)} replicated gradients before the "
          f"model group's average {pre_gap:.3e} of their norm (bound "
          f"{pre_bound:.3e}), their parameters and gradients after it "
          f"{max(peers):.3e} (bound 0) ({card})")
    check(peer_loss == 0 and pre_gap <= pre_bound and max(peers) == 0,
          "tp ranks: model peers differ")
    leaf = max(float((got[0]["grads"][i] - w).norm() / max(float(w.norm()),
                                                            1e-30))
               for i, w in zip(keep, w_g))
    loss, a_loss = rel(got[0]["stats"][0], want[0][0]), rel(alt[0][0],
                                                            want[0][0])
    later = max(rel(g, w) for g, w in zip(got[0]["stats"][1:], want[0][1:]))
    e_gap = 0.0
    for r in (got[0], got[2]):
        rows = slice(r["data_index"] * BATCH // 2,
                     (r["data_index"] + 1) * BATCH // 2)
        for k, v in eref.items():
            w = v[rows] if v.dim() and v.shape[0] == BATCH else v
            check(bool(torch.isfinite(r["eval"][k]).all()),
                  f"tp ranks: eval {k} not finite")
            e_gap = max(e_gap, float((r["eval"][k] - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
    bounds = (max(1e-5, DIST_SPREAD * a_loss),
              max(TP_RANKS_GRAD, DIST_SPREAD * a_vec))
    print(f"tp ranks: (2 x 2) in 4 processes against one [float32, global "
          f"batch {BATCH}, frozen BatchNorm, {TP_STEPS} steps]: first loss "
          f"terms {loss:.3e} (bound {bounds[0]:.3e}), later ones {later:.3e} "
          f"(bound {LOSS_TOL}), first gradients {g_vec:.3e} "
          f"(bound {bounds[1]:.3e}), worst leaf {leaf:.3e} (bound "
          f"{TP_RANKS_LEAF}), eval outputs {e_gap:.3e} of their scale "
          f"(bound {TP_RANKS_EVAL}); one "
          f"process's own run-to-run gap: loss {a_loss:.3e}, gradients "
          f"{a_vec:.3e} ({card})")
    check(loss <= bounds[0] and later <= LOSS_TOL and g_vec <= bounds[1]
          and leaf <= TP_RANKS_LEAF and e_gap <= TP_RANKS_EVAL,
          "tp ranks: the (2 x 2) steps differ from one process")


# ---- phase 7: the train/eval CLI on an H2O-format tree ----------------------

# the mini tree: H2O's frame size and intrinsics, records per split (10 test
# records at eval batch 8 leave a padded tail of 6)
CLI_FRAME = (720, 1280)
CLI_K = ((636.6593, 0.0, 635.2839), (0.0, 636.2520, 366.8740), (0, 0, 1))
CLI_TRAIN, CLI_TEST = 24, 10


def draw_hands(rng, consts):
    """One 1280x720 frame of two MANO hands with seeded coefficients ~0.55 m
    from the camera (CLI_K), their vertices splatted 5x5 into the frames:
    (rgb, 16-bit depth in mm, mask with the right hand in G and the left in
    R, 124 MANO coefficients, joints (42, 3), landmarks (42, 2), vertices
    (2, 778, 3) [left, right])."""
    import numpy as np
    import torch
    from pdfnet_tpu_torch.mano import layer as mano

    H, W = CLI_FRAME
    K = np.array(CLI_K, np.float32)
    coeff = np.zeros(124, np.float32)
    joints, lms, verts = [], [], []
    img = np.full((H, W, 3), 60, np.uint8)
    depth = np.zeros((H, W), np.uint16)
    mask = np.zeros((H, W, 3), np.uint8)
    for h, (side, xo) in enumerate((("left", -0.09), ("right", 0.06))):
        o = 62 * h
        coeff[o] = 1.0
        coeff[o + 1:o + 4] = [xo + rng.uniform(-0.02, 0.02),
                              rng.uniform(-0.03, 0.03),
                              0.55 + rng.uniform(-0.05, 0.05)]
        coeff[o + 4:o + 7] = rng.uniform(-0.3, 0.3, 3)
        coeff[o + 7:o + 52] = rng.uniform(-0.2, 0.2, 45)
        coeff[o + 52:o + 62] = rng.uniform(-0.5, 0.5, 10)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a[None]))
        with torch.no_grad():
            v, j = mano.mano_forward(
                consts[side], t(coeff[o + 4:o + 7]),
                t(coeff[o + 7:o + 52]), t(coeff[o + 52:o + 62]),
                trans=t(coeff[o + 1:o + 4]))
        v, j = v[0].numpy(), j[0].numpy()
        joints.append(j)
        verts.append(v)
        pj = j @ K.T
        lms.append(pj[:, :2] / pj[:, 2:])
        pv = v @ K.T
        uv = (pv[:, :2] / pv[:, 2:]).astype(int)
        ok = ((uv[:, 0] >= 2) & (uv[:, 0] < W - 2) & (uv[:, 1] >= 2)
              & (uv[:, 1] < H - 2))
        for (x, y), z in zip(uv[ok], v[ok, 2]):
            depth[y - 2:y + 3, x - 2:x + 3] = int(z * 1000)
            mask[y - 2:y + 3, x - 2:x + 3, 1 if side == "right" else 2] = 255
            img[y - 2:y + 3, x - 2:x + 3] = (180, 140, 120)
    return (img, depth, mask, coeff, np.concatenate(joints),
            np.concatenate(lms), np.stack(verts))


def mano_consts():
    from pdfnet_tpu_torch.mano import layer as mano
    return {s: mano.load_mano_consts(s, device="cpu")
            for s in ("left", "right")}


def write_h2o_tree(root: str, seed: int = 0) -> None:
    """An H2O-format tree (``{split}.pkl`` annotation caches, 16-bit depth in
    mm, rgb, and masks) of CLI_TRAIN + CLI_TEST records of ``draw_hands``."""
    import pickle

    import cv2
    import numpy as np

    rng = np.random.RandomState(seed)
    K = np.array(CLI_K, np.float32)
    consts = mano_consts()
    records = []
    for i in range(CLI_TRAIN + CLI_TEST):
        rel = f"subject1/h1/{i % 3}/cam4"
        for sub in ("rgb", "depth", "mask"):
            os.makedirs(os.path.join(root, "H2O", rel, sub), exist_ok=True)
        img, depth, mask, coeff, joints, lms, _ = draw_hands(rng, consts)
        name = f"{i:06d}.png"
        cv2.imwrite(os.path.join(root, "H2O", rel, "rgb", name), img)
        cv2.imwrite(os.path.join(root, "H2O", rel, "depth", name), depth)
        cv2.imwrite(os.path.join(root, "H2O", rel, "mask", name), mask)
        records.append({"imgpath": f"{rel}/rgb/{name}",
                        "depthpath": f"{rel}/depth/{name}",
                        "mano_coeff": coeff, "lms": lms.astype(np.float32),
                        "joints": joints.astype(np.float32),
                        "K": K, "id": 1 + i % 3})
    for split, recs in (("train", records[:CLI_TRAIN]),
                        ("test", records[CLI_TRAIN:])):
        with open(os.path.join(root, f"H2O_{split}.pkl"), "wb") as f:
            pickle.dump(recs, f)


def cli_phase(card, dev) -> None:
    """The port's train/eval CLI (``cli.main.main``) in process at the full
    width of the default ``Config`` on an H2O-format tree: ``--mode train``
    for 3 steps with an eval and a checkpoint, then ``--mode test`` from that
    checkpoint.  Checks the score files, the kernels' launches per train
    step and eval batch, the checkpoint round trip bit for bit, and a
    float32 test-mode evaluation of the checkpoint on the card against the
    CPU on 2 records; prints the train step, the loader's data wait and
    the eval rate through the loader."""
    import shutil

    import numpy as np
    import torch
    from pdfnet_tpu_torch.cli.main import main as cli_main
    from pdfnet_tpu_torch.data.h2o import H2ODataset
    from pdfnet_tpu_torch.ops import grouping, sa, trunk
    from pdfnet_tpu_torch.train.trainer import Trainer

    work = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(work, ignore_errors=True)
    tree, out = os.path.join(work, "tree"), os.path.join(work, "out")
    t0 = time.perf_counter()
    write_h2o_tree(tree)
    print(f"cli: H2O-format tree of {CLI_TRAIN} train and {CLI_TEST} test "
          f"records at {CLI_FRAME[1]}x{CLI_FRAME[0]} written in "
          f"{time.perf_counter() - t0:.1f} s")
    common = ["--cache_path", tree, "--pre_fix", tree, "--output_path", out,
              "--batch_size", str(BATCH), "--eval_batch_size", str(BATCH)]

    # the main path, once, through the user's entry point
    for m in (sa, grouping, trunk):
        m.reset_launches()
    t0 = time.perf_counter()
    trainer = cli_main(["--mode", "train", "--num_epochs", "1", "--steps",
                        "3", "--eval_every", "1", "--save_every", "1",
                        "--profile_sync"] + common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**sa.launches, **grouping.launches, **trunk.launches}
    steps, batches = 3, -(-CLI_TEST // BATCH)
    print(f"cli --mode train [bf16, batch {BATCH}, {steps} steps, eval of "
          f"{CLI_TEST} records]: kernel launches {json.dumps(launches)}; "
          f"{wall:.1f} s")
    want = {"knn_group_xyz": steps, "group_feat": steps,
            "sa_group_l1": batches, "sa_group_l2": batches,
            "sa_mlp_max": 2 * batches}
    check(all(launches[n] == v for n, v in want.items())
          and not any(launches[n] for n in launches if n not in want),
          f"cli train: expected launches {want}, got {launches}")
    prof = trainer.profiler
    # the first batch's wait fills the prefetch queue, the last is steady
    print(f"cli train s/step [bf16, batch {BATCH}, through the loader]: "
          f"{prof.batch_time.avg:.4f} (last {prof.batch_time.val:.4f}); "
          f"data wait ms/batch {prof.data_time.avg * 1e3:.2f} (last "
          f"{prof.data_time.val * 1e3:.2f}) ({card})")
    ckpt = os.path.join(out, "ckpt", "default", "model_0")
    vals = [p for p in os.listdir(os.path.join(out, "logs", "interact",
                                               "default"))]
    check(os.path.exists(ckpt) and len(vals) == 1, "cli train: no checkpoint "
          "or log directory")
    block = open(os.path.join(out, "logs", "interact", "default", vals[0],
                              "H2O-val.txt")).read()
    check(len(block.splitlines()) == 9, f"cli train: H2O-val.txt:\n{block}")
    saved = {n: p.detach().cpu().clone()
             for n, p in trainer.model.named_parameters()}
    del trainer

    t0 = time.perf_counter()
    tester = cli_main(["--mode", "test", "--load_model", ckpt] + common)
    torch.cuda.synchronize()
    print(f"cli --mode test: {time.perf_counter() - t0:.1f} s")
    restored = dict(tester.model.named_parameters())
    check(set(restored) == set(saved) and all(
        torch.equal(restored[n].detach().cpu(), saved[n]) for n in saved),
        "cli test: restored parameters differ from the trained ones")
    text = open(os.path.join(out, "H2O-val.txt")).read()
    vals = [float(line.split(": ")[1]) for line in text.splitlines()[1:]]
    check(len(vals) == 8 and all(np.isfinite(vals)),
          f"cli test: H2O-val.txt not 8 finite values:\n{text}")
    with open(os.path.join(out, "hand_poses.json")) as f:
        sub = json.load(f)
    frames = [len(v) for k, v in sub.items() if k != "modality"]
    entries = [x for k, v in sub.items() if k != "modality"
               for x in v.values()]
    check(sub.get("modality") == "RGBD" and sum(frames) == CLI_TEST
          and all(len(x) == 126 and np.isfinite(x).all() for x in entries),
          f"cli test: hand_poses.json has {sum(frames)} entries, want "
          f"{CLI_TEST} of 126 finite values (two hands of 21 joints)")
    print(f"cli test: H2O-val.txt and hand_poses.json ({CLI_TEST} entries) "
          f"written; parameters restored bit for bit; metrics {vals}")

    # eval frames/s through the loader (the test split, padded tail)
    data = H2ODataset(tester.cfg, "test")
    tester.evaluate(data.batches(BATCH, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tester.evaluate(data.batches(BATCH, 0))
    torch.cuda.synchronize()
    print(f"cli eval frames/s [bf16, batch {BATCH}, through the loader]: "
          f"{CLI_TEST / (time.perf_counter() - t0):.2f} ({card})")
    del tester

    # float32 test mode of the checkpoint: the card against the CPU
    cfg32 = data.cfg.replace(compute_dtype="float32", load_model=ckpt)
    batch = next(H2ODataset(cfg32, "test").batches(2, 0))
    outs = []
    for d in (dev, "cpu"):
        t = Trainer(cfg32, device=d)
        t.init_state()
        t.load(ckpt, resume_optimizer=False)
        outs.append({k: v.cpu() for k, v in t.eval_step(batch).items()})
        del t
    worst = 0.0
    for key, w in outs[1].items():
        g = outs[0][key]
        scale = max(1.0, w.abs().max().item())
        worst = max(worst, (g - w).abs().max().item() / scale)
        check(torch.allclose(g, w, atol=STEP_TOL * scale, rtol=STEP_TOL),
              f"cli f32 test mode: card differs from the CPU in {key}")
    print(f"cli test mode [f32, 2 records] card agrees with cpu: worst error "
          f"/ scale {worst:.3e} <= {STEP_TOL}")
    normals_cli_phase(tree, work)
    options_cli_phase(tree, work)
    csp_cli_phase(tree, work)
    dist_cli_phase(tree, work, DIST_GAPS)
    # keep the score files; the tree and the checkpoints (~300 MB each) go
    keep = os.path.join(OUT_DIR, "cli_scores")
    os.makedirs(keep, exist_ok=True)
    for name in ("H2O-val.txt", "hand_poses.json"):
        shutil.copy(os.path.join(out, name), keep)
    shutil.rmtree(work, ignore_errors=True)


# ---- phases 8-10: the serving and demo CLIs, the renderer, the bench -------

SERVE_FRAMES = 20
RATE_FRAMES = 320         # 40 batches of BATCH: no padded tail
RATE_RUNS = 5
SERVE_LAUNCHES = {"sa_group_l1": 1, "sa_group_l2": 1, "sa_mlp_max": 2}
RENDER_TOL = 1e-4         # depth and rgb, card against CPU, where both hit
RENDER_MASK_SHARE = 1e-3  # of the pixels whose mask may differ
# (flags, metric, kernels launched once a call of the timed function)
BENCH_MODES = (
    ([], "rgbd_inference_frames_per_sec_per_chip", SERVE_LAUNCHES),
    (["--self_contained", "--knn", "pallas", "--fused_trunk"],
     "rgbd_selfcontained_frames_per_sec_per_chip",
     {"knn": 2, "fused_bottleneck_s1": 8}),
    (["--train"], "train_samples_per_sec_per_chip",
     {"knn_group_xyz": 1, "group_feat": 1}))


def write_frames(root: str, n: int, seed: int = 1):
    """``color/NNNNNN.png`` and ``depth/NNNNNN.png`` (16-bit mm) of n
    ``draw_hands`` frames, the layout the serving CLIs read; returns the
    hands' vertices (n, 2, 778, 3)."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    consts = mano_consts()
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    verts = []
    for i in range(n):
        img, depth, _, _, _, _, v = draw_hands(rng, consts)
        cv2.imwrite(os.path.join(root, "color", f"{i:06d}.png"), img)
        cv2.imwrite(os.path.join(root, "depth", f"{i:06d}.png"), depth)
        verts.append(v)
    return np.stack(verts)


def serving_checkpoint(frames: str, path: str, dev) -> str:
    """A checkpoint of the default model (seeded random weights, jittered
    BatchNorm statistics) with the mask head split on the frames' crops
    (``split_masks_``), so that the CLIs' clouds come from half-image
    masks."""
    import glob

    import numpy as np
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.cli import demo, infer
    from pdfnet_tpu_torch.train.checkpoint import save_checkpoint

    cfg = port.Config()
    model = port.build_model(cfg, device=dev)
    jitter_bn_(model, seed=4)
    mean, std = (np.asarray(v, np.float32) for v in (cfg.mean, cfg.std))
    files = sorted(glob.glob(os.path.join(frames, "color", "*.png")))[:BATCH]
    img = np.stack([infer._preprocess(f, cfg.default_resolution, mean, std,
                                      demo.demo_intrinsics())[0]
                    for f in files])
    split_masks_(model, torch.from_numpy(img).to(dev))
    return save_checkpoint(path, port.create_train_state(cfg, model), 0)


def run_captured(fn, argv):
    """fn(argv) with its stdout captured; returns (result, the text), the
    text echoed without the progress counts."""
    import contextlib
    import io
    import re
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    text = buf.getvalue().replace("\r", "\n")
    for line in text.splitlines():
        if line.strip() and not re.fullmatch(r"\d+/\d+", line.strip()):
            print(f"  | {line}")
    return result, text


def serve_launches(batches: int):
    """The serving CLI's launch counts since the last reset, checked
    against SERVE_LAUNCHES a batch."""
    from pdfnet_tpu_torch.ops import grouping, sa, trunk
    launches = {**sa.launches, **grouping.launches, **trunk.launches}
    want = {n: v * batches for n, v in SERVE_LAUNCHES.items()}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"serve cli: expected launches {want}, got {launches}")
    return launches


def serve_cli_phase(card, dev, work: str, ckpt: str) -> None:
    """The serving CLI (``cli.infer.main``) in process at the default
    ``Config`` (bf16, ``pallas_sa``) at batch 8 on SERVE_FRAMES frames of
    1280x720: names, shapes, finiteness, the 126-float JSON and the
    kernels' launches a batch."""
    import numpy as np
    from pdfnet_tpu_torch.cli.infer import main as infer_main
    from pdfnet_tpu_torch.ops import grouping, sa, trunk

    frames, out = os.path.join(work, "frames"), os.path.join(work, "preds")
    batches = -(-SERVE_FRAMES // BATCH)
    # the serving CLI's path, through the user's entry point
    for m in (sa, grouping, trunk):
        m.reset_launches()
    t0 = time.perf_counter()
    _, text = run_captured(infer_main, ["--input", frames, "--batch",
                                        str(BATCH), "--json", "--ckpt",
                                        ckpt, "--out", out])
    wall = time.perf_counter() - t0
    launches = serve_launches(batches)
    print(f"serve cli [bf16, batch {BATCH}, {SERVE_FRAMES} frames of "
          f"{CLI_FRAME[1]}x{CLI_FRAME[0]}, {batches} batches]: kernel "
          f"launches {json.dumps(launches)}; {wall:.1f} s")
    preds = np.load(os.path.join(out, "predictions.npz"))
    names = [f"{i:06d}" for i in range(SERVE_FRAMES)]
    check(list(preds["names"]) == names, f"serve cli: names "
          f"{list(preds['names'])}")
    shapes = {"joints_abs": (21, 3), "joints_rel": (21, 3),
              "verts_abs": (778, 3), "lms2d": (21, 2)}
    for key, shape in shapes.items():
        check(preds[key].shape == (SERVE_FRAMES, 2) + shape
              and np.isfinite(preds[key]).all(),
              f"serve cli: {key} {preds[key].shape} or not finite")
    with open(os.path.join(out, "hand_poses.json")) as f:
        sub = json.load(f)
    check(list(sub) == names and all(len(v) == 126 and np.isfinite(v).all()
                                     for v in sub.values()),
          "serve cli: hand_poses.json is not 126 finite floats a frame")
    check(sum("steady-state" in line for line in text.splitlines()) == 1,
          "serve cli: no steady-state rate printed")
    print(f"serve cli: predictions and hand_poses.json ({SERVE_FRAMES} "
          f"frames) written")


def serve_rate_phase(card, work: str, ckpt: str) -> None:
    """The serving CLI's steady-state frames/s (its own timer, from the end
    of the first batch; PNG reads and warps included) on RATE_FRAMES
    frames, the SERVE_FRAMES written ones copied in turn, RATE_RUNS runs
    in process; prints each run's rate, the median and the spread."""
    import shutil

    import numpy as np
    from pdfnet_tpu_torch.cli.infer import main as infer_main
    from pdfnet_tpu_torch.ops import grouping, sa, trunk

    frames, rate = os.path.join(work, "frames"), os.path.join(work, "rate")
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(rate, sub), exist_ok=True)
        for i in range(RATE_FRAMES):
            shutil.copyfile(
                os.path.join(frames, sub, f"{i % SERVE_FRAMES:06d}.png"),
                os.path.join(rate, sub, f"{i:06d}.png"))
    rates = []
    for r in range(RATE_RUNS):
        for m in (sa, grouping, trunk):
            m.reset_launches()
        _, text = run_captured(infer_main, [
            "--input", rate, "--batch", str(BATCH), "--ckpt", ckpt,
            "--out", os.path.join(work, "rate_preds")])
        serve_launches(RATE_FRAMES // BATCH)
        line = [s for s in text.splitlines() if "steady-state" in s]
        check(len(line) == 1, "serve cli: no steady-state rate printed")
        rates.append(float(line[0].split()[1]))
    med = float(np.median(rates))
    print(f"serve cli steady-state frames/s [bf16, batch {BATCH}, "
          f"{RATE_FRAMES} frames of {CLI_FRAME[1]}x{CLI_FRAME[0]}, "
          f"{RATE_FRAMES // BATCH - 1} timed batches, host preprocessing "
          f"included], {RATE_RUNS} runs: {rates}; median {med}, spread "
          f"(max - min) / median {(max(rates) - min(rates)) / med:.4f} "
          f"({card})")
    shutil.rmtree(rate, ignore_errors=True)


def demo_cli_phase(card, dev, work: str, ckpt: str, verts) -> None:
    """The demo CLI (``cli.demo.main``) on 2 frames at 384x384: its three
    JPGs a frame and the kernels' launches a frame; then
    ``render_two_hands`` of the drawn hands on the card against the CPU,
    and its ms a call on the card."""
    import cv2
    import numpy as np
    import torch
    from pdfnet_tpu_torch import Config, assets
    from pdfnet_tpu_torch.cli.demo import crop_rgbd, load_rgbd
    from pdfnet_tpu_torch.cli.demo import main as demo_main
    from pdfnet_tpu_torch.ops import grouping, sa, trunk
    from pdfnet_tpu_torch.render import render_two_hands

    frames, out = os.path.join(work, "frames"), os.path.join(work, "demo")
    res = Config().default_resolution
    for m in (sa, grouping, trunk):
        m.reset_launches()
    t0 = time.perf_counter()
    run_captured(demo_main, ["--input", frames, "--limit", "2", "--ckpt",
                             ckpt, "--out", out])
    wall = time.perf_counter() - t0
    launches = {**sa.launches, **grouping.launches, **trunk.launches}
    print(f"demo cli [bf16, 2 frames at {res}x{res}]: kernel launches "
          f"{json.dumps(launches)}; {wall:.1f} s")
    want = {n: 2 * v for n, v in SERVE_LAUNCHES.items()}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"demo cli: expected launches {want}, got {launches}")
    for i in range(2):
        for kind in ("mask_lr", "bones_lr", "render"):
            img = cv2.imread(os.path.join(out, "color",
                                          f"{kind}_{i:06d}.jpg"))
            check(img is not None and img.shape == (res, res, 3),
                  f"demo cli: {kind}_{i:06d}.jpg missing or not "
                  f"({res}, {res}, 3)")
    print("demo cli: mask, bones and render JPGs of 2 frames written")

    # the renderer: the drawn hands under the crop's intrinsics
    image, depth = load_rgbd(os.path.join(frames, "color", "000000.png"))
    K = crop_rgbd(image, depth, np.array(CLI_K, np.float32), res)[2]
    faces = (assets.load_mano("left").faces, assets.load_mano("right").faces)
    outs = []
    for d in (dev, torch.device("cpu")):
        v = torch.from_numpy(verts[0]).to(d)
        outs.append([t.cpu() for t in render_two_hands(
            v[0], v[1], torch.from_numpy(K).to(d), *faces, res, res)])
    (rgb, mask, zbuf), (rgb_c, mask_c, zbuf_c) = outs
    both = (mask > 0) & (mask_c > 0)
    share = (mask != mask_c).float().mean().item()
    err_z = (zbuf - zbuf_c)[both].abs().max().item()
    err_rgb = (rgb - rgb_c)[both].abs().max().item()
    check(mask_c.sum() > 0.01 * res * res, "render: the hands cover under "
          "1 % of the image")
    check(share <= RENDER_MASK_SHARE and err_z <= RENDER_TOL
          and err_rgb <= RENDER_TOL,
          f"render: card against CPU: mask differs on {share:.2e} of the "
          f"pixels, depth {err_z:.2e}, rgb {err_rgb:.2e}")
    v = torch.from_numpy(verts[0]).to(dev)
    Kd = torch.from_numpy(K).to(dev)
    ms = time_ms(lambda: render_two_hands(v[0], v[1], Kd, *faces, res, res),
                 iters=10)
    print(f"render_two_hands [{res}x{res}, 3076 faces] card agrees with cpu: "
          f"mask differs on {share:.2e} of the pixels (<= "
          f"{RENDER_MASK_SHARE}), depth {err_z:.2e}, rgb {err_rgb:.2e} "
          f"(<= {RENDER_TOL}) where both hit; {ms:.3f} ms a call ({card})")


def bench_phase(card) -> None:
    """``python -m pdfnet_tpu_torch.bench`` in its three modes at
    ``bench.py``'s defaults, each a subprocess: exit 0, one JSON line with
    the mode's metric, a positive value and a null ``vs_baseline``, and
    the kernels of the mode launched once a timed call (warm-up
    included)."""
    for flags, metric, per_call in BENCH_MODES:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "pdfnet_tpu_torch.bench"]
                             + flags, cwd=REPO, capture_output=True,
                             text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"bench {flags}: exit {run.returncode}\n"
              f"{run.stderr[-4000:]}")
        lines = run.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench {flags}: stdout is not one line: "
              f"{run.stdout!r}")
        got = json.loads(lines[0])
        check(list(got) == ["metric", "value", "unit", "vs_baseline"]
              and got["metric"] == metric and got["value"] > 0
              and got["vs_baseline"] is None,
              f"bench {flags}: {lines[0]}")
        launches = json.loads([line for line in run.stderr.splitlines()
                               if line.startswith("launches ")][-1][9:])
        calls = 3 + 60                       # bench.py's warmup + iters
        want = {n: v * calls for n, v in per_call.items()}
        check(all(launches[n] == want.get(n, 0) for n in launches),
              f"bench {flags}: expected launches {want}, got {launches}")
        print(f"bench {' '.join(flags) or '(eval)'} ({wall:.1f} s, launches "
              f"{json.dumps(want)}; {card}):")
        print(lines[0])


def cli_serving_phases(card, dev) -> None:
    """Phases 8-10 on one set of frames and one checkpoint under
    chiprun_out/serve/; the frames and the checkpoint are deleted after,
    the predictions and the JPGs kept."""
    import shutil
    work = os.path.join(OUT_DIR, "serve")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    verts = write_frames(os.path.join(work, "frames"), SERVE_FRAMES)
    ckpt = serving_checkpoint(os.path.join(work, "frames"),
                              os.path.join(work, "ckpt"), dev)
    print(f"serve: {SERVE_FRAMES} color/depth pairs at {CLI_FRAME[1]}x"
          f"{CLI_FRAME[0]} and a checkpoint written in "
          f"{time.perf_counter() - t0:.1f} s")
    serve_cli_phase(card, dev, work, ckpt)
    serve_rate_phase(card, work, ckpt)
    demo_cli_phase(card, dev, work, ckpt, verts)
    for sub in ("frames", "ckpt", "rate_preds"):
        shutil.rmtree(os.path.join(work, sub), ignore_errors=True)
    bench_phase(card)


def profile(fn, label: str, steps: int = 5) -> float:
    """Device time by kernel over a few steps of ``fn``: the table goes to
    chiprun_out/profile_{label}.txt, a summary line (device busy share, the
    port's kernels' share) to stdout.  Returns the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = p.key_averages()
    # device-side events only: an operator's row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    own_ms = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in ("sa_group_kernel",
                                             "sa_mlp_f32_kernel",
                                             "sa_mlp_max_kernel",
                                             "sa_mlp_tc_kernel",
                                             "bottleneck_kernel",
                                             "bottleneck_tc_kernel",
                                             "bottleneck_f32_kernel"))
                 ) / 1e3 / steps
    print(f"profile [{label}]: wall {wall:.3f} ms/step, device "
          f"{device:.3f} ms/step (busy {device / wall:.3f}), the port's "
          f"kernels {own_ms:.3f} ms/step ({own_ms / device:.3f} of device)")
    # operators (not kernels) by their kernels' device time, and the
    # optimizer's annotated range, per step
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    print(f"profile [{label}] device ms/step by operator: " + ", ".join(
        f"{e.key} {e.self_device_time_total / 1e3 / steps:.3f} "
        f"({e.count // steps} calls)" for e in ops[:10]))
    host = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"profile [{label}] host ms/step by operator: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3 / steps:.3f}"
        for e in host[:8]))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return device / wall


def rates_kernel_times(card, dev) -> None:
    """``--rates``: every kernel's ms a call by CUDA-graph replay at the main
    path's shapes at batch 8, bf16 and float32, through the wrappers every
    tree of the port has (the kernel phase's inputs and weights)."""
    import torch
    import pdfnet_tpu_torch as port
    from pdfnet_tpu_torch.ops import grouping, sa, trunk

    cfg = port.Config()
    gen = torch.Generator().manual_seed(0)
    xyz, feat = kernel_inputs(cfg, gen, dev)
    S1, S2, k = cfg.sample_num_level1, cfg.sample_num_level2, cfg.knn_k
    r1, r2 = cfg.ball_radius, cfg.ball_radius2
    w1 = folded_mlp(sa.MLP_WIDTHS[0], 3, gen, dev)
    w2 = folded_mlp(sa.MLP_WIDTHS[1], feat.shape[-1], gen, dev)
    fb = feat.bfloat16().contiguous()
    calls = [("sa_group_l1 [f32]", lambda: sa.sa_group_l1(xyz, S1, k, r1)),
             ("sa_group_l2 [bf16]", lambda: sa.sa_group_l2(fb, S2, k, r2)),
             ("knn_group_xyz [f32]",
              lambda: grouping.knn_group_xyz(xyz, S1, k)),
             ("group_feat [bf16]", lambda: grouping.group_feat(fb, S2, k, r2)),
             ("knn [level 1]", lambda: sa.knn(xyz[:, :S1].contiguous(), xyz,
                                              k))]
    for kk in (k, 128, 256):
        g1 = sa.group_plain(xyz, S1, kk, r1)
        g2 = sa.group_plain(feat, S2, kk, r2)
        for level, g, w in ((1, g1, w1), (2, g2, w2)):
            for cdt in (torch.float32, torch.bfloat16):
                if kk != k and cdt == torch.bfloat16:
                    continue
                gin = g.to(cdt).contiguous() if level == 2 else g
                wc = [(wi.to(cdt), bi) for wi, bi in w]
                calls.append((f"sa_mlp_max [level {level} "
                              f"{str(cdt).split('.')[-1]} k={kk}]",
                              lambda gin=gin, wc=wc, cdt=cdt:
                              sa.sa_mlp_max(gin, wc, cdt)))
    for name, hw, cin, cw, stride in TRUNK_CASES[:2]:
        block = random_bottleneck(cin, cw, stride, gen).to(dev)
        with torch.no_grad():
            folded = trunk.fold_bottleneck(block)
        x32 = torch.relu(torch.randn((BATCH, hw, hw, cin), generator=gen))
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dev, dt).contiguous()
            fw = {n: v.to(dt) if n.startswith("w") else v
                  for n, v in folded.items()}
            calls.append((f"fused_bottleneck_s1 [{name} "
                          f"{str(dt).split('.')[-1]}]",
                          lambda x=x, fw=fw: trunk.fused_bottleneck(x, fw)))
    for label, fn in calls:
        print(f"rates: kernel {label}: ms {graph_ms(fn):.4f} ({card})")


def f32_rates_phase(card, dev, with_profile: bool) -> None:
    """``--rates``: the float32 eval, serving and train steps at batch 8 and
    32 at the default ``Config``'s widths (TF32 off), through the steps
    every tree of the port has, so that one command measures a parent and
    its change alike; with ``--profile`` each eval and serving step's device
    time by kernel."""
    import torch
    import pdfnet_tpu_torch as port

    cfg = port.Config(compute_dtype="float32")
    res, n = cfg.default_resolution, cfg.sample_num
    consts = port.load_loss_consts(dev)
    batches = {B: {k: torch.from_numpy(v).to(dev)
                   for k, v in bench_batch(B, res, n, seed=1).items()}
               for B in (BATCH, 4 * BATCH)}
    model = port.build_model(cfg, device=dev)
    jitter_bn_(model, seed=1)
    step = port.make_eval_step(cfg, model, consts)
    for B, b in batches.items():
        print(f"rates: eval step frames/s [f32, batch {B}]: "
              f"{fps(step, b, B):.2f} ({card})")
        if with_profile:
            profile(lambda b=b: step(b), f"rates_eval_f32_b{B}")
    scfg = cfg.replace(knn_method="pallas", fused_trunk=True)
    model = port.build_model(scfg, device=dev)
    jitter_bn_(model, seed=3)
    split_masks_(model, batches[BATCH]["input"])
    step = make_serve_step(scfg, model, consts,
                           torch.Generator(device=dev).manual_seed(0))
    for B, b in batches.items():
        print(f"rates: serve step frames/s [f32, batch {B}]: "
              f"{fps(step, b, B):.2f} ({card})")
        if with_profile:
            profile(lambda b=b: step(b), f"rates_serve_f32_b{B}")
    del model, step, batches
    for B in (BATCH, 4 * BATCH):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in port.make_batch(cfg, B, seed=0).items()}
        model = port.build_model(cfg, device=dev)
        state = port.create_train_state(cfg, model)
        tstep = port.make_train_step(cfg, model, consts)
        gen = torch.Generator(device=dev).manual_seed(0)
        lr = port.lr_at_epoch(cfg, 0)
        for _ in range(TRAIN_WARMUP):
            tstep(state, batch, 0, lr, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_ITERS):
            tstep(state, batch, 0, lr, gen)
        torch.cuda.synchronize()
        rate = B * TRAIN_ITERS / (time.perf_counter() - t0)
        print(f"rates: train step samples/s [f32, batch {B}]: {rate:.2f} "
              f"({card})")
        del model, state, tstep, batch
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the bf16 eval, train and serving "
                         "steps and the float32 eval and serving steps at "
                         "batch 8 and 32")
    ap.add_argument("--ranks", type=int, default=0,
                    help="instead: the train CLI in this many processes, "
                         "one a card, against one process (and with 4, "
                         "the (2 x 2) layout's train and eval steps)")
    ap.add_argument("--rates", action="store_true",
                    help="instead: every kernel's ms at the main shapes, "
                         "and the float32 eval, serving and train steps' "
                         "rates at batch 8 and 32 (with --profile, their "
                         "device time by kernel)")
    ap.add_argument("--tp_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script runs on the card only")
    if not os.path.isdir(os.path.join(REPO, "pdfnet_tpu_torch", "csrc")):
        return fail("pdfnet_tpu_torch/ not found beside chip_smoke.py: run "
                    "it from a checkout of the repository")
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.coordinator, args.out)
    from pdfnet_tpu_torch import Config
    from pdfnet_tpu_torch.ops import cuda_build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(cuda_build.SOURCES)})")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    if args.rates:
        rates_kernel_times(card, torch.device("cuda"))
        f32_rates_phase(card, torch.device("cuda"), args.profile)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.ranks:
        check(torch.cuda.device_count() >= args.ranks,
              f"--ranks {args.ranks} needs as many cards")
        ranks_phase(card, args.ranks)
        if args.ranks == 4:
            tp_ranks_phase(card, torch.device("cuda"))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    cfg, dev = Config(), torch.device("cuda")     # bf16, the default
    steps = kernel_phase(cfg, dev)
    launches = eval_phase(args, card, cfg, dev)
    cap_eval_check(cfg, dev)
    launches.update({n: v for n, v in train_phase(args, card, cfg, dev).items()
                     if n in TRAIN_KERNELS})
    train_check_phase(cfg, dev)
    launches.update({n: v for n, v in serve_phase(args, card, cfg, dev).items()
                     if n in SERVE_KERNELS or n == "fused_bottleneck_s2"})
    normals_phase(card, cfg, dev)
    options_phase(card, cfg, dev)
    csp_phase(card, cfg, dev)
    for n, v in dist_phase(card, cfg, dev).items():
        launches[n] += v
    for n, v in tp_phase(card, cfg, dev).items():
        launches[n] += v
    cli_phase(card, dev)
    cli_serving_phases(card, dev)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        s = steps[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain"],
            "bound_ms": s["bound"],
            "bound_by": max(s["by"], key=s["by"].get),
            "library_ms": None, "yardstick_ms": s["yard"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
