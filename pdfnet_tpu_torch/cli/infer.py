"""Batched serving CLI of the PyTorch port: stream RGB-D pairs through the
model (port of ``pdfnet_tpu/cli/infer.py``).

Directory of ``color/*.png`` + ``depth/*.png`` pairs -> fixed-size batches
-> the self-contained RGB-D inference path (predicted centers/masks/clouds,
demo.py semantics) -> per-frame predictions (absolute + root-relative
joints/verts, 2D landmarks) written as one ``predictions.npz`` (+ optional
per-frame JSON in the H2O challenge 126-float layout,
base_trainer.py:328-335).

Host preprocessing (cv2 warps) overlaps device compute via a
double-buffered producer thread; the final partial batch is padded and the
padding results dropped.  A failure in the producer (an unreadable PNG, a
color frame without its depth) reaches the consumer, which re-raises it
naming the file; the JAX CLI's consumer waits for ever there.  Every batch
samples its clouds with a generator on the device re-seeded to 0.

Usage:
  python -m pdfnet_tpu_torch.cli.infer --input assets/H2O \\
      --ckpt outputs/ckpt/default/model_X --batch 48 --out outputs/preds
  python -m pdfnet_tpu_torch.cli.infer --cpu ...   # on the CPU, not the card
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pdfnet_tpu_torch.cli.demo import (build_parser, crop_rgbd,
                                       demo_intrinsics, load_rgbd, setup)

OUTPUT_KEYS = ("verts_pred", "joints_pred", "joints_pred_off", "lms21_pred")


def _preprocess(img_file: str, res: int, mean, std, K: np.ndarray):
    image, depth = load_rgbd(img_file)
    img_c, depth_c, K_img = crop_rgbd(image, depth, K, res)
    inp = (img_c.astype(np.float32) / 255.0 - mean) / std
    return inp, depth_c.astype(np.float32), K_img


def _batches(files, batch, res, mean, std, K):
    """Double-buffered host pipeline: preprocess batch i+1 while the device
    runs batch i.  Yields (files, n, input, depth, K); the tail batch is
    padded up to ``batch`` (``n`` marks the real sample count).  A producer
    failure is raised here, naming the file; the producer and the thread
    pool are stopped on every exit."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():             # the consumer may have left
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def load(f):
        try:
            return _preprocess(f, res, mean, std, K)
        except Exception as e:
            raise RuntimeError(f"preprocessing {f} failed: {e}") from e

    def produce(pool):
        try:
            for i in range(0, len(files), batch):
                chunk = files[i:i + batch]
                outs = list(pool.map(load, chunk))
                n = len(outs)
                outs += [outs[-1]] * (batch - n)      # pad the tail batch
                if not put((chunk, n, *(np.stack([o[j] for o in outs])
                                        for j in range(3)))):
                    return
        except Exception as e:                # handed to the consumer
            put(e)
            return
        put(None)

    pool = ThreadPoolExecutor(8)
    t = threading.Thread(target=produce, args=(pool,), daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
        pool.shutdown(wait=True, cancel_futures=True)


def main(argv=None):
    ap = build_parser("outputs/preds")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--json", action="store_true",
                    help="also write per-frame H2O challenge 126-float json")
    args = ap.parse_args(argv)

    import torch

    from pdfnet_tpu_torch.models.handnet import infer_rgbd
    from pdfnet_tpu_torch.train.loss import eval_outputs

    B, res = args.batch, args.res
    cfg, model, consts, files = setup(args, B)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    valid = torch.ones((B, 2), dtype=torch.float32, device=device)

    def run(inp, depth, K):
        out = infer_rgbd(model, inp, depth, K, valid, gen.manual_seed(0))
        out = eval_outputs(cfg, consts, *out, {"K_new": K})
        return {k: out[k].float().cpu().numpy() for k in OUTPUT_KEYS}

    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)
    names, joints, joints_off, verts, lms = [], [], [], [], []
    t0 = time.perf_counter()
    t_steady = None                   # set after batch 1 (excludes warm-up)
    done = done_steady = 0
    for chunk, n, inp, depth, K_img in _batches(files, B, res, mean, std,
                                                demo_intrinsics()):
        out = run(inp, depth, torch.from_numpy(K_img).to(device))
        names += [os.path.basename(f)[:-4] for f in chunk]
        joints.append(out["joints_pred"][:n])
        joints_off.append(out["joints_pred_off"][:n])
        verts.append(out["verts_pred"][:n])
        lms.append(out["lms21_pred"][:n])
        done += n
        if t_steady is None:
            t_steady, done_steady = time.perf_counter(), done
        print(f"\r{done}/{len(files)}", end="", flush=True)
    dt = time.perf_counter() - t0
    print(f"\n{done} frames in {dt:.2f}s (incl. the first batch's warm-up)")
    if done > done_steady:
        ds = time.perf_counter() - t_steady
        print(f"steady-state: {(done - done_steady) / ds:.1f} fps "
              f"(host preprocessing included)")

    os.makedirs(args.out, exist_ok=True)
    joints = np.concatenate(joints)
    np.savez(os.path.join(args.out, "predictions.npz"),
             names=np.asarray(names), joints_abs=joints,
             joints_rel=np.concatenate(joints_off),
             verts_abs=np.concatenate(verts), lms2d=np.concatenate(lms))
    if args.json:
        # H2O challenge layout: 126 floats = (left 21x3, right 21x3) flat
        sub = {nm: joints[i].reshape(-1).tolist()
               for i, nm in enumerate(names)}
        with open(os.path.join(args.out, "hand_poses.json"), "w") as f:
            json.dump(sub, f)
    print(f"wrote {args.out}/predictions.npz"
          + (" + hand_poses.json" if args.json else ""))


if __name__ == "__main__":
    main()
