"""Train / val / test CLI of the PyTorch port (port of
``pdfnet_tpu/cli/main.py``; main.py + scripts/train.sh equivalent).

Usage:
  python -m pdfnet_tpu_torch.cli.main --mode train --dataset H2O \\
      --batch_size 8 --default_resolution 384 --num_epochs 80
  python -m pdfnet_tpu_torch.cli.main --mode test \\
      --load_model outputs/ckpt/default/model_56
  python -m pdfnet_tpu_torch.cli.main --mode train --synthetic --steps 5
  python -m pdfnet_tpu_torch.cli.main --cpu ...   # on the CPU, not the card

Runs on one CUDA device unless ``--cpu`` is given.  The flags are the JAX
CLI's, generated from the port's ``Config``.  ``--arch csp_50|csp_18``
trains the CSP detector; ``--mode val|test`` with it fails, as in JAX, in
``Trainer.evaluate`` (NotImplementedError).  Refused by name when the flags
are parsed: ``--zero1_opt_sharding``, whose path the port lacks
(``check_trainer_config``), the device limits of ``check_config``, the
multi-process flags (``--coordinator``, ``--num_processes``,
``--process_id``) and ``--no-depth``.  Writes
``{output_path}/{dataset}-val.txt`` (val and test)
and ``{output_path}/hand_poses.json`` (test), the train logs under
``{output_path}/logs`` and the checkpoints under
``{output_path}/ckpt/{exp_id}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

_CHOICES = {
    "arch": ["resnet50", "csp_50", "csp_18"],
    "mode": ["train", "val", "test"],
    "sample_strategy": ["random", "FPS"],
    "knn_method": ["topk", "approx", "pallas", "pallas_fused", "pallas_sa"],
    "gather_method": ["take", "onehot"],
    "compute_dtype": ["bfloat16", "float32"],
    "optimizer": ["Adam"],
}

_HELP = {
    "arch": "resnet50 = flagship HandNet; csp_* = the legacy MANO-theta "
            "regression detector (train-only)",
    "eval_batch_size": "eval loader batch (default batched: exact via the "
                       "tail pad_mask; set 1 for a reference-identical loop)",
    "bn_stat_groups": "G>1: emulate G DDP replicas exactly — each group "
                      "computes BatchNorm statistics over batch/G rows (the "
                      "reference's multi-GPU semantics); 0/1 = global-batch "
                      "(synced) BN",
    "patch_heads": "evaluate non-hm CenterNet heads only at the two hand "
                   "centers (exact, big FLOP cut for wh/params/texture/light "
                   "consumers)",
    "profile_dir": "capture a torch.profiler trace window here (Chrome "
                   "trace, view in Perfetto)",
    "image_summary": "write input|pred|gt render grids every "
                     "image_summary_every steps",
    "input_feature_num": "3 = xyz point clouds, 6 = xyz+surface normals",
    "photometric_loss": "differentiable-render photometric/silhouette loss "
                        "terms (+texture/light heads)",
    "off": "train the off_hm/off_lms sub-pixel offset heads",
    "freeze_bn_stats": "BatchNorm uses running statistics even in training "
                       "(frozen-BN fine-tuning)",
    "skip_nonfinite_updates": "skip parameter updates when the loss is "
                              "non-finite (decided on the device)",
    "sample_deterministic": "self-contained RGB-D path samples the first N "
                            "in-band pixels instead of a random subset "
                            "(reproducible serving)",
}


def _tuple_arg(elem):
    def parse(s):
        s = s.strip()
        return tuple(elem(t) for t in s.split(",")) if s else ()
    return parse


def build_argparser() -> argparse.ArgumentParser:
    """Every ``Config`` field is a flag: the parser is generated from the
    dataclass (booleans get --x/--no-x pairs so default-on flags like
    --reproj_loss can be disabled), plus the CLI-only flags."""
    from pdfnet_tpu_torch.config import Config

    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        name, kw = f"--{f.name}", {"help": _HELP.get(f.name)}
        if f.name in _CHOICES:
            kw["choices"] = _CHOICES[f.name]
        ftype = str(f.type)
        if ftype == "bool":
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default, help=kw["help"])
        elif ftype == "int":
            ap.add_argument(name, type=int, default=f.default, **kw)
        elif ftype == "float":
            ap.add_argument(name, type=float, default=f.default, **kw)
        elif ftype == "str":
            ap.add_argument(name, default=f.default, **kw)
        elif "Tuple[int" in ftype:
            ap.add_argument(name, type=_tuple_arg(int), default=f.default,
                            metavar="N,N,...", **kw)
        elif "Tuple[float" in ftype:
            ap.add_argument(name, type=_tuple_arg(float), default=f.default,
                            metavar="X,X,...", **kw)
        else:                                  # pragma: no cover
            raise TypeError(f"unhandled Config field type {f.type!r} "
                            f"for {f.name}")

    # CLI-only flags (not Config fields)
    ap.add_argument("--depth", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="RGB-D input (the published PDFNet recipe; "
                         "--no-depth is rejected — RGB-only records are "
                         "handled per-dataset with zero-padded clouds)")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no H2O caches needed)")
    ap.add_argument("--steps", type=int, default=0,
                    help="cap steps per epoch (smoke runs)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--coordinator", default="",
                    help="multi-process training: not in the port yet "
                         "(refused when set)")
    ap.add_argument("--num_processes", type=int, default=0,
                    help="multi-process training: not in the port yet")
    ap.add_argument("--process_id", type=int, default=-1,
                    help="multi-process training: not in the port yet")
    ap.add_argument("--eval_every", type=int, default=5,
                    help="run eval every N epochs while training "
                         "(reference main.py:115)")
    ap.add_argument("--save_every", type=int, default=5,
                    help="checkpoint every N epochs (reference main.py:123)")
    ap.add_argument("--vis_every", type=int, default=0,
                    help="eval-loop visual dumps (overlay/skeleton/.obj) "
                         "every N samples, as the reference does every 500")
    return ap


def config_from_args(args):
    """Round-trip the parsed namespace into a ``Config`` (all fields)."""
    from pdfnet_tpu_torch.config import Config
    return Config(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(Config)})


def check_args(args) -> None:
    """Refuse, by name, the CLI-only values the port has no path for."""
    if not args.depth:
        raise SystemExit(
            "--no-depth: the published PDFNet model is RGB-D; RGB-only "
            "records (FreiHAND) are handled per-dataset with zero-padded "
            "clouds instead of an RGB-only architecture")
    multi = [f for f, is_set in (("--coordinator", args.coordinator != ""),
                                 ("--num_processes", args.num_processes != 0),
                                 ("--process_id", args.process_id != -1))
             if is_set]
    if multi:
        raise NotImplementedError(
            f"{', '.join(multi)}: the port trains in one process on one "
            f"device (multi-process training is not in the port yet)")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    check_args(args)
    cfg = config_from_args(args)

    from pdfnet_tpu_torch.models.handnet import check_config
    from pdfnet_tpu_torch.train.trainer import (Trainer, check_trainer_config,
                                                fit)
    if not cfg.arch.startswith("csp"):
        check_config(cfg)
    check_trainer_config(cfg)
    device = "cpu" if args.cpu else "cuda"

    if args.synthetic:
        from pdfnet_tpu_torch.data.synthetic import SyntheticHandDataset
        train_data = SyntheticHandDataset(cfg, size=max(64, cfg.batch_size * 8))
        eval_data = SyntheticHandDataset(cfg, size=8, seed=1, train=False)
    else:
        from pdfnet_tpu_torch.data.h2o import H2ODataset
        if args.mode == "train":
            train_data = H2ODataset(cfg, "train")
            eval_data = H2ODataset(cfg, "test")
        else:
            train_data = None
            eval_data = H2ODataset(cfg, args.mode)

    log_dir = os.path.join(cfg.output_path, "logs", cfg.task, cfg.exp_id,
                           time.strftime("logs_%Y-%m-%d-%H-%M"))
    ckpt_dir = os.path.join(cfg.output_path, "ckpt", cfg.exp_id)

    if args.mode == "train":
        return fit(cfg, train_data, eval_data, log_dir=log_dir,
                   ckpt_dir=ckpt_dir, eval_every=args.eval_every,
                   save_every=args.save_every,
                   max_steps_per_epoch=args.steps or None, device=device)
    trainer = Trainer(cfg, device=device)
    trainer.init_state()
    if cfg.load_model:
        trainer.load(cfg.load_model, resume_optimizer=False)
    # the H2O submission is exact at any eval batch: id/frame_num ride the
    # padded batched loader and pad rows are masked out (the reference
    # forces bs=1 for it, base_trainer.py:486)
    acc = trainer.evaluate(eval_data.batches(cfg.eval_batch_size, 0),
                           vis_every=args.vis_every,
                           vis_dir=os.path.join(cfg.output_path, "imgs"))
    acc.all_reduce()
    block = acc.format_block(cfg.exp_id)
    print(block)
    os.makedirs(cfg.output_path, exist_ok=True)
    with open(os.path.join(cfg.output_path, f"{cfg.dataset}-val.txt"),
              "a") as f:
        f.write(block)
    if args.mode == "test":
        acc.write_h2o_submission(
            os.path.join(cfg.output_path, "hand_poses.json"))
    return trainer


if __name__ == "__main__":
    main()
