#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pdfnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the root of a checkout
    python3 chip_smoke.py --profile   # also profiles the bf16 eval step

Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA source in ``pdfnet_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. every kernel at the shapes of the main path at batch 8 (16 hands),
   against its plain PyTorch version on the same inputs: the grouping
   kernels bit for bit (identical neighbour selection, exact ties planted),
   the MLP kernel within a stated tolerance; kernel, plain and bound times;
4. the batched RGB-D eval step (``build_model`` + ``make_eval_step``) at the
   full width of the default ``Config`` with seeded random weights and
   jittered BatchNorm statistics, on the bench's batch layout: output shapes
   and finiteness, the kernels' launch counts in one step, the float32 step
   on the card against the same model on the CPU (plain versions) at batch
   1, and frames/s in bfloat16 and float32.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so every float32 number is true
float32.  The line before the last lists the kernels as JSON; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
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

SOURCES = {"sa_group_l1": ("pdfnet_tpu_torch/csrc/sa_group.cu",
                           "pdfnet_tpu/ops/pallas_knn.py:172"),
           "sa_group_l2": ("pdfnet_tpu_torch/csrc/sa_group.cu",
                           "pdfnet_tpu/ops/pallas_knn.py:107"),
           "sa_mlp_max": ("pdfnet_tpu_torch/csrc/sa_mlp.cu",
                          "pdfnet_tpu/ops/pallas_knn.py:201")}


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


def group_bound(H, N, C, S, k, esize):
    """(ms, bound_by): read the rows once, write the groups once; d2 and one
    compare per (center, point) pair at the float32 rate."""
    bytes_ = (H * N * C + H * S * k * C) * esize
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


def kernel_phase(cfg, dev):
    """Every kernel at the main path's shapes in float32 and bfloat16,
    against its plain version.  Returns per-kernel numbers of the calls one
    eval step makes in the default (bf16) compute dtype."""
    import torch
    from pdfnet_tpu_torch.ops import sa

    gen = torch.Generator().manual_seed(0)
    xyz, feat = kernel_inputs(cfg, gen, dev)
    H, N = xyz.shape[:2]
    S1, S2, k = cfg.sample_num_level1, cfg.sample_num_level2, cfg.knn_k
    r1, r2 = cfg.ball_radius, cfg.ball_radius2
    w1 = folded_mlp(sa.MLP_WIDTHS[0], 3, gen, dev)
    w2 = folded_mlp(sa.MLP_WIDTHS[1], feat.shape[-1], gen, dev)
    steps = {}

    def record(name, case, err, ms, plain_ms, bound, step_case):
        print(f"kernel {name} [{case}]: max_abs_err {err:.3e} ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {bound[0]:.4f} "
              f"({bound[1]})")
        if step_case:
            s = steps.setdefault(name, dict(err=0.0, ms=0.0, plain=0.0,
                                            bound=0.0, by={}))
            s["err"] = max(s["err"], err)
            s["ms"] += ms
            s["plain"] += plain_ms
            s["bound"] += bound[0]
            s["by"][bound[1]] = s["by"].get(bound[1], 0.0) + bound[0]

    # sa_group_l1: float32 points, as on the main path
    got = sa.sa_group_l1(xyz, S1, k, r1)
    want = sa.group_plain(xyz, S1, k, r1)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err == 0.0, f"sa_group_l1 differs from its plain version ({err})")
    print(f"kernel sa_group_l1: neighbourhoods bit-identical (same "
          f"neighbours, same order); in-ball share "
          f"{(got.abs().sum(-1) > 0).float().mean().item():.3f}")
    record("sa_group_l1", "f32", err,
           time_ms(lambda: sa.sa_group_l1(xyz, S1, k, r1)),
           time_ms(lambda: sa.group_plain(xyz, S1, k, r1), iters=5),
           group_bound(H, N, 3, S1, k, 4), True)

    # sa_group_l2: rows in the compute dtype (bf16 on the main path)
    for dt, step_case in ((torch.float32, False), (torch.bfloat16, True)):
        f = feat.to(dt).contiguous()
        got = sa.sa_group_l2(f, S2, k, r2)
        want = sa.group_plain(f, S2, k, r2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err == 0.0, f"sa_group_l2 [{dt}] differs from its plain "
                          f"version ({err})")
        record("sa_group_l2", str(dt).split(".")[-1], err,
               time_ms(lambda: sa.sa_group_l2(f, S2, k, r2)),
               time_ms(lambda: sa.group_plain(f, S2, k, r2), iters=5),
               group_bound(H, S1, f.shape[-1], S2, k, f.element_size()),
               step_case)

    # sa_mlp_max at both levels' shapes, float32 and bf16 compute
    g1 = sa.group_plain(xyz, S1, k, r1)
    g2 = sa.group_plain(feat, S2, k, r2)
    for level, g, w in ((1, g1, w1), (2, g2, w2)):
        for cdt in (torch.float32, torch.bfloat16):
            # on the main path level 2 groups bf16 rows in bf16 mode
            gin = g.to(cdt).contiguous() if level == 2 else g
            got = sa.sa_mlp_max(gin, w, cdt)
            want = sa.mlp_max_plain(gin, w, cdt)
            torch.cuda.synchronize()
            tol = MLP_TOL_BF16 if cdt == torch.bfloat16 else MLP_TOL_F32
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **tol)
            check(ok, f"sa_mlp_max level {level} [{cdt}] outside {tol} "
                      f"(max abs {err})")
            C = gin.shape[-1]
            record("sa_mlp_max", f"level {level} {str(cdt).split('.')[-1]}",
                   err, time_ms(lambda: sa.sa_mlp_max(gin, w, cdt)),
                   time_ms(lambda: sa.mlp_max_plain(gin, w, cdt)),
                   mlp_bound(H, gin.shape[1], k, C, sa.MLP_WIDTHS[level - 1],
                             gin.element_size(), cdt == torch.bfloat16),
                   cdt == torch.bfloat16)
    return steps


# ---- phase 4: the eval step ------------------------------------------------

def bench_batch(B, res, n, seed=0):
    """The bench's batch layout (bench.py:57-68)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return {
        "input": rng.randn(B, res, res, 3).astype(np.float32),
        "choose": rng.randint(0, res * res, (B, 2, n)).astype(np.int32),
        "cloud": rng.uniform(-0.1, 0.1, (B, 2, n, 3)).astype(np.float32),
        "depth": rng.uniform(0.3, 0.8, (B, res, res)).astype(np.float32),
        "K_new": np.tile(np.array([[[480.0, 0, res / 2], [0, 480.0, res / 2],
                                    [0, 0, 1]]], np.float32), (B, 1, 1)),
        "valid": np.ones((B, 2), np.float32),
        "lms_left_gt": np.zeros((B, 21, 2), np.float32),
        "lms_right_gt": np.zeros((B, 21, 2), np.float32),
    }


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
    from pdfnet_tpu_torch.ops import sa

    cfg32 = cfg.replace(compute_dtype="float32")
    res, n = cfg.default_resolution, cfg.sample_num
    model = port.build_model(cfg, device=dev)
    jitter_bn_(model, seed=1)
    consts = port.load_loss_consts(dev)
    step = port.make_eval_step(cfg, model, consts)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in bench_batch(BATCH, res, n).items()}

    # the main path, once, through the user's entry points
    sa.reset_launches()
    out = step(batch)
    torch.cuda.synchronize()
    launches = dict(sa.launches)
    print(f"eval step [bf16, batch {BATCH}] kernel launches: "
          f"{json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    check(sum(launches.values()) == 4, f"expected 4 launches: {launches}")
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
    got = port.make_eval_step(cfg32, m32, consts)(b1)
    want = port.make_eval_step(cfg32, mcpu, port.load_loss_consts("cpu"))(
        {k: v.cpu() for k, v in b1.items()})
    worst = 0.0
    for key in want:
        g, w = got[key].cpu(), want[key]
        scale = max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        worst = max(worst, err / scale)
        print(f"eval step [f32, batch 1] card vs cpu {key}: max_abs_err "
              f"{err:.3e} (scale {scale:.3e})")
        check(torch.allclose(g, w, atol=STEP_TOL * scale, rtol=STEP_TOL),
              f"f32 eval step on the card differs from the CPU in {key}")
    print(f"eval step [f32] card agrees with cpu: worst error / scale "
          f"{worst:.3e} <= {STEP_TOL}")

    # throughput, host clock around synchronized loops, TF32 off
    step32 = port.make_eval_step(cfg32, m32, consts)
    big = {k: torch.from_numpy(v).to(dev)
           for k, v in bench_batch(4 * BATCH, res, n, seed=1).items()}
    for dt, st, b, B in (("bf16", step, batch, BATCH),
                         ("f32", step32, batch, BATCH),
                         ("bf16", step, big, 4 * BATCH)):
        print(f"eval step frames/s [{dt}, batch {B}]: {fps(st, b, B):.2f} "
              f"({card})")
    if args.profile:
        for b, B in ((batch, BATCH), (big, 4 * BATCH)):
            profile(step, b, B)
    return launches


def profile(step, batch, B, steps: int = 5) -> None:
    """Device time by kernel over a few bf16 steps: the table goes to
    chiprun_out/, a summary line (device busy share, set-abstraction share)
    to stdout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    step(batch)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = p.key_averages()
    # device-side events only: an operator's row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    sa_ms = sum(e.self_device_time_total for e in kernels
                if "sa_group_kernel" in e.key or "sa_mlp_max_kernel" in e.key
                ) / 1e3 / steps
    print(f"profile [bf16, batch {B}]: wall {wall:.3f} ms/step, device "
          f"{device:.3f} ms/step (busy {device / wall:.3f}), set-abstraction "
          f"kernels {sa_ms:.3f} ms/step ({sa_ms / device:.3f} of device)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_eval_bf16_b{B}.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile bf16 eval steps at batch 8 and 32")
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

    cfg, dev = Config(), torch.device("cuda")     # bf16, the default
    steps = kernel_phase(cfg, dev)
    launches = eval_phase(args, card, cfg, dev)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        s = steps[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain"],
            "bound_ms": s["bound"],
            "bound_by": max(s["by"], key=s["by"].get),
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
