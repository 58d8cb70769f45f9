"""Epoch-driven trainer (port of ``pdfnet_tpu/train/trainer.py``: ``Logger``,
``Trainer``, ``fit``).

Reference: lib/trains/base_trainer.py:81-199 (run_epoch) + main.py:107-143
(epoch loop, LR steps, periodic eval/checkpoint).  One device a process,
the card unless the caller asks for the CPU (``device="cpu"``).  A step is
forward, loss, backward and the Adam update (``train.step``); the epoch's
stats stay on the device between the logging steps.

In a process group (``parallel.mesh.maybe_initialize_distributed``) each
process is one rank of a data-parallel run, as the JAX trainer's
processes are (``trainer.py:332-395``): ``fit`` gives each rank its stripe
of every global batch, the train step makes the global batch's update
(``train.step``; ``zero1_opt_sharding`` splits the Adam moments over the
ranks), the evaluation is striped and merged
(``MetricAccumulator.all_reduce``), and rank 0 alone logs and writes the
score and checkpoint files.  ``save`` is collective; ``load`` reads the
file on every rank.  A checkpoint's format does not depend on the number
of ranks.

``arch="csp_*"`` trains the CSP detector (``models.csp``, ``csp_loss``), as
the JAX trainer dispatches on it (``trainer.py:65-76``); it has no eval
step, so ``evaluate`` raises and ``fit`` skips the evaluation, and, as in
JAX, it refuses ``zero1_opt_sharding``.  With ``photometric_loss`` or
``image_summary`` the epoch writes an ``input | pred | gt`` render grid
every ``image_summary_every`` steps (rendered on the trainer's device)
through ``Logger.image``; the CSP detector writes none, as in JAX.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from pdfnet_tpu_torch.config import Config
from pdfnet_tpu_torch.data.prefetch import prefetch
from pdfnet_tpu_torch.models.csp import CSPNet, csp_from_config
from pdfnet_tpu_torch.models.handnet import (HandNet, init_weights,
                                             resolve_device)
from pdfnet_tpu_torch.parallel import mesh
from pdfnet_tpu_torch.render.rasterizer import render_two_hands
from pdfnet_tpu_torch.train import checkpoint as ckpt_lib
from pdfnet_tpu_torch.train.loss import load_loss_consts
from pdfnet_tpu_torch.train.mano_branch import load_mano_branch_consts
from pdfnet_tpu_torch.train.metrics import MetricAccumulator
from pdfnet_tpu_torch.train.step import (TrainState, create_train_state,
                                         lr_at_epoch, make_csp_train_step,
                                         make_eval_step, make_train_step)
from pdfnet_tpu_torch.utils.profiler import StepProfiler


def check_trainer_config(cfg: Config) -> None:
    """Raise the JAX trainer's ValueError for ``zero1_opt_sharding`` with
    the CSP detector (``trainer.py:110-113``), and a ValueError under a
    2-D layout with a model axis > 1 (``mesh.make_mesh_2d``): the trainer
    runs data parallelism only, as JAX's has no 2-D path."""
    model_axis = mesh.current_mesh().model
    if model_axis > 1:
        raise ValueError(
            f"the trainer under a model axis of {model_axis}: it runs data "
            "parallelism only (the 2-D layout is the train and eval steps')")
    if cfg.arch.startswith("csp") and cfg.zero1_opt_sharding:
        raise ValueError(
            "zero1_opt_sharding is only wired for the flagship HandNet "
            "trainer; the CSP alternate detector would silently "
            "replicate — drop the flag or use the HandNet arch")


class Logger:
    """Console + JSONL logger (replaces tensorboardX text/scalar logging)."""

    def __init__(self, log_dir: str, cfg: Config):
        os.makedirs(log_dir, exist_ok=True)
        self.dir = log_dir
        with open(os.path.join(log_dir, "opt.txt"), "w") as f:
            for k, v in sorted(vars(cfg).items()):
                f.write(f"{k}: {v}\n")
        self.f = open(os.path.join(log_dir, "log.jsonl"), "a")

    def scalars(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def image(self, step: int, tag: str, img: np.ndarray) -> str:
        """Write a uint8 BGR image summary (replaces TB image_summary)."""
        import cv2
        img_dir = os.path.join(self.dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        path = os.path.join(img_dir, f"{tag}_{step:08d}.png")
        cv2.imwrite(path, img)
        return path

    def write(self, msg: str):
        print(msg, flush=True)

    def close(self):
        self.f.close()


class Trainer:
    """The model, its loss constants, train and eval steps, and the train
    state, on one device (one rank's, in a process group).  ``arch="csp_*"`` builds the CSP detector with
    its MANO constants and train step, and no eval step.  As in JAX, the
    weights are drawn by ``init_state``: until then a model the trainer
    builds holds torch's default initialization."""

    def __init__(self, cfg: Config, model: Optional[HandNet | CSPNet] = None,
                 device="cuda"):
        check_trainer_config(cfg)
        self.cfg = cfg
        self.is_csp = cfg.arch.startswith("csp")
        self.device = resolve_device(device)
        if model is None:
            model = csp_from_config(cfg) if self.is_csp else HandNet(cfg)
            model = model.to(self.device).eval()
        self.model = model
        if self.is_csp:
            self.consts = load_mano_branch_consts(self.device)
            self.train_step = make_csp_train_step(cfg, self.model,
                                                  self.consts)
            self.eval_step = None
        else:
            self.consts = load_loss_consts(self.device)
            self.train_step = make_train_step(cfg, self.model, self.consts)
            self.eval_step = make_eval_step(cfg, self.model, self.consts)
        self.state: Optional[TrainState] = None
        self.profiler = StepProfiler(cfg.profile_dir, cfg.profile_start_step,
                                     cfg.profile_num_steps,
                                     sync=cfg.profile_sync)
        self._gen = torch.Generator(device=self.device)

    def init_state(self, sample_batch: Optional[Dict[str, np.ndarray]] = None,
                   seed: int = 317) -> TrainState:
        """Fresh weights seeded by ``seed`` (flax's initializers) and a new
        Adam state.  The JAX trainer traces its model on ``sample_batch``;
        the port's model needs no batch, and ignores it."""
        del sample_batch
        # the initializers draw on the CPU, as build_model's do
        init_weights(self.model.to("cpu"), seed)
        self.model.to(self.device)
        self.state = create_train_state(self.cfg, self.model)
        return self.state

    def run_epoch(self, epoch: int, batches: Iterable[Dict[str, np.ndarray]],
                  logger: Optional[Logger] = None,
                  log_every: int = 10) -> Dict[str, float]:
        """Train steps over ``batches``; returns the epoch's mean of each
        loss stat and the profiler's meters.  Dropout draws from a generator
        seeded by (epoch, step), the counterpart of
        ``fold_in(PRNGKey(epoch), i)``."""
        lr = lr_at_epoch(self.cfg, epoch)
        # stats accumulate on the device: reading one on the host waits for
        # the card, which happens only every log_every steps and at the end
        running = None
        n = 0
        self.profiler.reset_epoch()
        img_every = self.cfg.image_summary_every
        log_images = (logger is not None and img_every > 0 and
                      (self.cfg.photometric_loss or self.cfg.image_summary))
        try:
            for i, batch in enumerate(batches):
                self.profiler.data_tick()
                self._gen.manual_seed((epoch << 32) + i)
                with self.profiler.step():
                    stats = self.train_step(self.state, batch, epoch, lr,
                                            self._gen)
                n += 1
                running = (stats if running is None else
                           {k: running[k] + v for k, v in stats.items()})
                if logger and i % log_every == 0:
                    cur = {k: float(v) for k, v in stats.items()}
                    logger.scalars(self.state.step, cur)
                    avg = {k: float(v) / n for k, v in running.items()}
                    # the reference's Bar.suffix "|loss avg |cur_loss val"
                    # line (base_trainer.py:154-165)
                    logger.write(f"train: [{epoch}][{i}]"
                                 f"|loss {avg.get('loss', 0.0):.4f} "
                                 f"|cur_loss {cur.get('loss', 0.0):.4f}")
                if log_images and (n - 1) % img_every == 0:
                    grid = self.image_summary(batch)
                    if grid is not None:
                        logger.image(self.state.step, "train", grid)
        finally:
            self.profiler.close()
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        if running is None:
            return {}
        out = {k: float(v) / n for k, v in running.items()}
        out.update(self.profiler.summary())
        return out

    def image_summary(self, batch: Dict[str, np.ndarray],
                      max_imgs: int = 4) -> Optional[np.ndarray]:
        """An ``input | pred | gt`` grid of the first ``max_imgs`` samples
        of a host batch (reference base_trainer.py:174-190 image_summary):
        the eval step's absolute meshes rendered on the trainer's device
        and laid over the input.  Returns a uint8 BGR image, or None before
        ``init_state`` or without an eval step (the CSP detector)."""
        from pdfnet_tpu_torch.utils.vis import denormalize_image

        if self.state is None or self.eval_step is None:
            return None
        cfg = self.cfg
        n = min(max_imgs, batch["input"].shape[0])
        out = self.eval_step({k: v[:n] for k, v in batch.items()})
        res = cfg.default_resolution
        sets = [out["verts_pred"]] + ([out["verts_gt"]] if "verts_gt" in out
                                      else [])
        rows = []
        with torch.no_grad():
            for i in range(n):
                img = denormalize_image(np.asarray(batch["input"][i]),
                                        cfg.mean, cfg.std)
                panels = [img]
                K = torch.as_tensor(np.asarray(batch["K_new"][i]),
                                    device=self.device)
                for verts in sets:
                    rgb, rmask, _ = render_two_hands(
                        verts[i, 0], verts[i, 1], K, self.consts.faces_left,
                        self.consts.faces_right, res, res)
                    rgb = rgb.cpu().numpy()[..., ::-1] * 255
                    rmask = rmask.cpu().numpy()[..., None]
                    panels.append((rgb * rmask + img * (1 - rmask))
                                  .astype(np.uint8))
                rows.append(np.concatenate(panels, axis=1))
        return np.concatenate(rows, axis=0)

    def evaluate(self, batches: Iterable[Dict[str, np.ndarray]],
                 vis_every: int = 0, vis_dir: str = "outputs/imgs",
                 ) -> MetricAccumulator:
        """The eval step over ``batches`` into a ``MetricAccumulator``: the
        loader's padded tail runs with its batch, and its padded rows
        (``pad_mask`` 0) are dropped by the accumulator.  The CSP detector
        has no eval step and raises NotImplementedError, as in JAX."""
        if self.eval_step is None:
            raise NotImplementedError(
                "mesh evaluation is only defined for the flagship HandNet "
                "arch; the CSP detector is a training-era alternate "
                "(reference origforward path)")
        acc = MetricAccumulator()
        seen = 0
        next_vis = 0
        for batch in batches:
            out = self.eval_step(batch)
            host_out = {k: v.float().cpu().numpy() for k, v in out.items()}
            # threshold crossing: once per vis_every samples for any batch
            # size (seen % vis_every misses whenever the batch size does not
            # divide vis_every)
            if vis_every and seen >= next_vis:
                self._dump_eval_vis(host_out, batch, seen, vis_dir)
                next_vis += vis_every
            seen += batch["input"].shape[0]
            acc.update(host_out, batch)
        return acc

    def _dump_eval_vis(self, out: Dict[str, np.ndarray],
                       batch: Dict[str, np.ndarray], file_id: int,
                       vis_dir: str) -> None:
        """Eval-loop visual spot checks (reference simplified.py:285-330,
        545-596, every 500 samples): projected-vertex overlay, predicted
        skeleton, and pred/GT .obj mesh dumps for the first batch sample."""
        import cv2

        from pdfnet_tpu_torch import assets
        from pdfnet_tpu_torch.utils.vis import (denormalize_image,
                                                draw_hand_skeleton,
                                                draw_landmarks, write_obj)

        os.makedirs(vis_dir, exist_ok=True)
        cfg = self.cfg
        img = denormalize_image(batch["input"][0], cfg.mean, cfg.std)

        K = np.asarray(batch["K_new"][0])
        verts = out["verts_pred"][0]                     # (2, 778, 3) abs
        overlay = img.copy()
        for hand, color in ((0, (0, 0, 255)), (1, (0, 255, 0))):
            uvw = verts[hand] @ K.T
            uv = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-6)
            overlay = draw_landmarks(overlay, uv, color=color, size=2)
        cv2.imwrite(os.path.join(vis_dir, f"image_proj_left_{file_id}.jpg"),
                    overlay)
        bones = draw_hand_skeleton(img.copy(), out["lms21_pred"][0, 0])
        draw_hand_skeleton(
            bones, out["lms21_pred"][0, 1],
            os.path.join(vis_dir, f"kps_bone_pred_{file_id}.jpg"))

        faces = {"l": assets.load_mano("left").faces,
                 "r": assets.load_mano("right").faces}
        off = out["verts_pred_off"][0]
        for hand, side in ((0, "l"), (1, "r")):
            write_obj(os.path.join(vis_dir, f"{side}hands_{file_id}.obj"),
                      off[hand], faces[side])
        if "verts_gt_off" in out:
            gt = out["verts_gt_off"][0]
            for hand, side in ((0, "l"), (1, "r")):
                write_obj(
                    os.path.join(vis_dir, f"gt_hands_{side}{file_id}.obj"),
                    gt[hand], faces[side])

    def save(self, ckpt_dir: str, epoch: int) -> Optional[str]:
        """Checkpoint the state; returns the path on rank 0, None
        elsewhere.  COLLECTIVE under ``zero1_opt_sharding`` in a process
        group (the split moments are gathered first), so every rank must
        call it, as ``fit`` does."""
        host = mesh.gather_to_host(self.state)
        if mesh.process_index() != 0:
            return None
        return ckpt_lib.save_checkpoint(ckpt_dir, host, epoch)

    def load(self, path: str, resume_optimizer: bool = True) -> int:
        """Restore the state from a checkpoint written by any number of
        ranks; returns the epoch it was saved after.  Every rank calls it
        and reads the file."""
        self.state, epoch = ckpt_lib.load_checkpoint(path, self.state,
                                                     resume_optimizer)
        return epoch


def fit(cfg: Config, train_data, eval_data=None, log_dir: str = "outputs/logs",
        ckpt_dir: str = "outputs/ckpt", eval_every: int = 5,
        save_every: int = 5, max_steps_per_epoch: Optional[int] = None,
        device="cuda") -> Trainer:
    """Full training recipe (scripts/train.sh equivalent): epochs of
    ``run_epoch`` over a prefetched loader, the step-decay LR, an
    evaluation every ``eval_every`` epochs appended to
    ``{log_dir}/{dataset}-val.txt`` (none for the CSP detector), a
    checkpoint every ``save_every``.

    In a process group (the reference's torch.distributed.launch and rank-0
    gating, main.py:69-173) every rank calls it: each loads its stripe of
    the global batch of ``cfg.batch_size`` (``process_local_batch_size``),
    the evaluation is striped the same way and merged, and rank 0 alone
    logs and writes files."""
    P, pi = mesh.process_count(), mesh.process_index()
    local_bs = mesh.process_local_batch_size(cfg.batch_size)
    trainer = Trainer(cfg, device=device)
    logger = Logger(log_dir, cfg) if pi == 0 else None
    log = logger.write if logger else (lambda *_: None)
    trainer.init_state()
    start_epoch = cfg.start_epoch
    if cfg.load_model:
        # checkpoints record the epoch they were saved AFTER; resume at the
        # next one (reference main.py:107 range(start_epoch + 1, ...))
        start_epoch = trainer.load(cfg.load_model) + 1
        log(f"resumed from {cfg.load_model}; "
            f"continuing at epoch {start_epoch}")
    try:
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            gen = train_data.batches(local_bs, epoch, process_index=pi,
                                     process_count=P)
            if max_steps_per_epoch:
                gen = itertools.islice(gen, max_steps_per_epoch)
            means = trainer.run_epoch(epoch, prefetch(gen, depth=2), logger)
            log(f"epoch {epoch}: loss={means.get('loss', float('nan')):.3f} "
                f"({time.time() - t0:.1f}s, lr={lr_at_epoch(cfg, epoch):.2e})")
            if (eval_data is not None and trainer.eval_step is not None
                    and eval_every > 0 and (epoch + 1) % eval_every == 0):
                # each rank scores records pi, pi+P, ...; the merge is the
                # collective, every rank calls it
                acc = trainer.evaluate(eval_data.batches(
                    cfg.eval_batch_size, 0, process_index=pi,
                    process_count=P))
                acc.all_reduce()
                if pi == 0:
                    block = acc.format_block(f"epoch {epoch}")
                    log(block)
                    with open(os.path.join(log_dir,
                                           f"{cfg.dataset}-val.txt"),
                              "a") as f:
                        f.write(block)
            if save_every > 0 and (epoch + 1) % save_every == 0:
                # every rank calls save (collective under zero1); rank 0
                # writes and gets a path back
                path = trainer.save(ckpt_dir, epoch)
                if path:
                    log(f"saved {path}")
    finally:
        if logger:
            logger.close()
    return trainer
