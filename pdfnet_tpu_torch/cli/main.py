"""Train / val / test CLI of the PyTorch port (port of
``pdfnet_tpu/cli/main.py``; main.py + scripts/train.sh equivalent).

Usage:
  python -m pdfnet_tpu_torch.cli.main --mode train --dataset H2O \\
      --batch_size 8 --default_resolution 384 --num_epochs 80
  python -m pdfnet_tpu_torch.cli.main --mode test \\
      --load_model outputs/ckpt/default/model_56
  python -m pdfnet_tpu_torch.cli.main --mode train --synthetic --steps 5
  python -m pdfnet_tpu_torch.cli.main --cpu ...   # on the CPU, not the card

  # N processes, one a device (rank i on cuda:{i % device_count}):
  python -m pdfnet_tpu_torch.cli.main --mode train --coordinator H:P \
      --num_processes N --process_id i ...
  # or torch's environment rendezvous (MASTER_ADDR, MASTER_PORT,
  # WORLD_SIZE, RANK), as torchrun sets it:
  torchrun --nproc_per_node N -m pdfnet_tpu_torch.cli.main --mode train ...

Runs on the card unless ``--cpu`` is given (then a process group uses
gloo; on the card NCCL).  The flags are the JAX CLI's, generated from the
port's ``Config``.  Several processes train one model on the global batch
``--batch_size``, each on its stripe; ``--mode val|test`` stripes the split
and merges the metrics; rank 0 writes the files.  ``--arch csp_50|csp_18``
trains the CSP detector; ``--mode val|test`` with it fails, as in JAX, in
``Trainer.evaluate`` (NotImplementedError), and ``--zero1_opt_sharding``
with it raises JAX's ValueError.  Refused by name when the flags are
parsed: the device limits of ``check_config``, an incomplete set of the
multi-process flags, and ``--no-depth``.  Writes
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
                    help="multi-process run: host:port of rank 0's "
                         "rendezvous (torch.distributed, tcp://)")
    ap.add_argument("--num_processes", type=int, default=0,
                    help="multi-process run: the number of processes")
    ap.add_argument("--process_id", type=int, default=-1,
                    help="multi-process run: this process's rank")
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
    """Refuse, by name, the CLI-only values the port has no path for, and
    multi-process flags that do not name one rank of a group."""
    if not args.depth:
        raise SystemExit(
            "--no-depth: the published PDFNet model is RGB-D; RGB-only "
            "records (FreiHAND) are handled per-dataset with zero-padded "
            "clouds instead of an RGB-only architecture")
    if not args.coordinator:
        given = [f for f, is_set in (("--num_processes",
                                      args.num_processes != 0),
                                     ("--process_id", args.process_id != -1))
                 if is_set]
        if given:
            raise ValueError(f"{', '.join(given)} without --coordinator")
    elif not 0 <= args.process_id < args.num_processes:
        raise ValueError(
            f"--coordinator needs --num_processes >= 1 and 0 <= --process_id "
            f"< --num_processes (got {args.num_processes}, "
            f"{args.process_id})")


def main(argv=None):
    """Parse ``argv``, join the process group the flags (or torch's
    environment variables) name, and train or evaluate.  A group this call
    creates is destroyed before it returns."""
    args = build_argparser().parse_args(argv)
    check_args(args)
    cfg = config_from_args(args)

    from pdfnet_tpu_torch.models.handnet import check_config
    from pdfnet_tpu_torch.train.trainer import check_trainer_config
    if not cfg.arch.startswith("csp"):
        check_config(cfg)
    check_trainer_config(cfg)

    import torch.distributed as dist

    from pdfnet_tpu_torch.parallel import mesh
    created = not mesh.is_distributed()
    # the process group (the torch.distributed.launch + NCCL init role,
    # reference main.py:69-75)
    if mesh.maybe_initialize_distributed(
            coordinator=args.coordinator or None,
            num_processes=args.num_processes or None,
            process_id=args.process_id if args.process_id >= 0 else None,
            device="cpu" if args.cpu else "cuda"):
        print(f"multi-host: process {mesh.process_index()} of "
              f"{mesh.process_count()}", flush=True)
    try:
        return _run(args, cfg)
    finally:
        if created and mesh.is_distributed():
            dist.destroy_process_group()


def _run(args, cfg):
    import torch

    from pdfnet_tpu_torch.parallel import mesh
    from pdfnet_tpu_torch.train.trainer import Trainer, fit

    P, pi = mesh.process_count(), mesh.process_index()
    # one device a rank: cuda:{rank % device_count}
    device = ("cpu" if args.cpu else
              f"cuda:{pi % torch.cuda.device_count()}" if mesh.is_distributed()
              else "cuda")

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
    # forces bs=1 for it, base_trainer.py:486); striped over the ranks
    # (1/N of the split each), the partial sums and submission rows merged,
    # rank 0 writes the files
    acc = trainer.evaluate(
        eval_data.batches(cfg.eval_batch_size, 0, process_index=pi,
                          process_count=P),
        vis_every=args.vis_every if pi == 0 else 0,
        vis_dir=os.path.join(cfg.output_path, "imgs"))
    acc.all_reduce()
    if pi != 0:
        return trainer
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
