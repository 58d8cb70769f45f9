"""Throughput benchmark of the PyTorch port (port of the repo's
``bench.py``): batched RGB-D inference frames/s on one CUDA device.

    python -m pdfnet_tpu_torch.bench                      # eval step
    python -m pdfnet_tpu_torch.bench --self_contained --knn pallas --fused_trunk
    python -m pdfnet_tpu_torch.bench --train              # train samples/s

Prints ONE JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline"}``, with ``bench.py``'s metric names
(``rgbd_inference_frames_per_sec_per_chip``,
``rgbd_selfcontained_frames_per_sec_per_chip``,
``train_samples_per_sec_per_chip``), and the kernels' launch counts of the
run on stderr.  ``vs_baseline`` is null: ``bench.py`` divides by its own
baselines, a throughput target set for a TPU and a guess at the
reference's GPU recipe; neither is a figure measured for this port or this
device.  The flags and defaults are ``bench.py``'s.

The loop is ``bench.py``'s: ``warmup`` calls, a synchronize, ``iters``
calls timed on the host clock, a synchronize.  The weights are random,
seeded by ``Config.seed``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--res", type=int, default=384)
    ap.add_argument("--knn", default="pallas_sa",
                    choices=["topk", "approx", "pallas", "pallas_fused",
                             "pallas_sa"])
    ap.add_argument("--fused_trunk", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="fused resnet blocks at eval")
    ap.add_argument("--s2d_stem", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="stem conv via space-to-depth (exact)")
    ap.add_argument("--self_contained", action="store_true",
                    help="bench the single-pass RGB-D serving path "
                         "(infer_rgbd: no host clouds, mask->cloud on the "
                         "device)")
    ap.add_argument("--train", action="store_true",
                    help="bench the train step (samples/s)")
    ap.add_argument("--train_batch", type=int, default=8)
    return ap


def random_batch(B: int, res: int, n: int, seed: int = 0):
    """``bench.py``'s random batch (bench.py:57-68; its seed is 0)."""
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


def _timed(call, warmup: int, iters: int, sync) -> float:
    """Seconds of ``iters`` calls after ``warmup`` calls, the device drained
    before and after."""
    for _ in range(warmup):
        out = call()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = call()
    sync()
    del out
    return time.perf_counter() - t0


def main(argv=None, device: str = "cuda") -> dict:
    """Run the benchmark on ``device`` (the card unless the caller asks for
    the CPU) and print its JSON line; returns the printed dict."""
    args = build_parser().parse_args(argv)

    import torch

    from pdfnet_tpu_torch.config import Config
    from pdfnet_tpu_torch.models.handnet import build_model, infer_rgbd
    from pdfnet_tpu_torch.ops import grouping, sa, trunk
    from pdfnet_tpu_torch.train.loss import load_loss_consts
    from pdfnet_tpu_torch.train.step import (create_train_state,
                                             make_eval_step, make_train_step)
    from pdfnet_tpu_torch.utils.precision import tf32_off

    tf32_off()          # float32 is true float32
    cfg = Config(default_resolution=args.res, batch_size=args.batch,
                 compute_dtype="bfloat16", knn_method=args.knn,
                 fused_trunk=args.fused_trunk, s2d_stem=args.s2d_stem)
    if args.train:
        cfg = cfg.replace(batch_size=args.train_batch)
    model = build_model(cfg, device=device)
    device = next(model.parameters()).device
    consts = load_loss_consts(device)
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    gen = torch.Generator(device=device).manual_seed(0)
    to_dev = lambda b: {k: torch.from_numpy(v).to(device)
                        for k, v in b.items()}
    for m in (sa, grouping, trunk):
        m.reset_launches()

    if args.train:
        from pdfnet_tpu_torch.data.synthetic import make_batch
        B = args.train_batch
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, model, consts)
        batch = to_dev(make_batch(cfg, B, seed=0))
        dt = _timed(lambda: step(state, batch, 30, cfg.lr, gen),
                    args.warmup, args.iters, sync)
        metric, unit = "train_samples_per_sec_per_chip", "samples/s"
    else:
        B = args.batch
        batch = to_dev(random_batch(B, args.res, cfg.sample_num))
        if args.self_contained:
            def call():
                gen.manual_seed(0)
                return infer_rgbd(model, batch["input"], batch["depth"],
                                  batch["K_new"], batch["valid"], gen)
            metric = "rgbd_selfcontained_frames_per_sec_per_chip"
        else:
            step = make_eval_step(cfg, model, consts)
            call = lambda: step(batch)
            metric = "rgbd_inference_frames_per_sec_per_chip"
        unit = "frames/s"
        dt = _timed(call, args.warmup, args.iters, sync)

    launches = {**sa.launches, **grouping.launches, **trunk.launches}
    print(f"launches {json.dumps(launches)}", file=sys.stderr)
    line = {"metric": metric, "value": round(B * args.iters / dt, 2),
            "unit": unit, "vs_baseline": None}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
