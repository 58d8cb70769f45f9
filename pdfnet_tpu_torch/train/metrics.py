"""Evaluation metrics: abs / root-relative MPJPE + MPVPE (mm), 2D px error
(port of ``pdfnet_tpu/train/metrics.py``; host-side numpy).

Matches the accumulation in the reference evaluator
(base_trainer.py:207-491): per-sample mean euclidean error, averaged over
the split, x1000 to millimetres; plus the H2O challenge submission dict.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np


class MetricAccumulator:
    KEYS = ("abs_mpjpe_left", "abs_mpjpe_right", "abs_mpvpe_left",
            "abs_mpvpe_right", "off_mpjpe_left", "off_mpjpe_right",
            "off_mpvpe_left", "off_mpvpe_right", "lms_px")

    def __init__(self):
        self.sums = {k: 0.0 for k in self.KEYS}
        self.count = 0
        self.h2o_submission: Dict[str, Dict] = {"modality": "RGBD"}
        self._action_lists: Dict[int, Dict] = {}

    def update(self, out: Dict[str, np.ndarray],
               batch: Dict[str, np.ndarray]) -> None:
        """out: eval_outputs dict (numpy); batch provides lms GT and ids.

        Padded tail rows (batch['pad_mask'] == 0, emitted by the batch
        loader so every batch has one shape) are excluded, making batched
        eval exact for any split size."""
        w = np.asarray(batch.get(
            "pad_mask", np.ones(out["joints_pred"].shape[0], np.float32)))

        def err(pred, gt):          # (B, N, C) -> weighted per-sample sum
            per = np.linalg.norm(pred - gt, axis=-1).mean(axis=-1)   # (B,)
            return float((per * w).sum())

        n = float(w.sum())
        if "joints_gt" in out:
            self.sums["abs_mpjpe_left"] += err(out["joints_pred"][:, 0],
                                               out["joints_gt"][:, 0]) * 1000
            self.sums["abs_mpjpe_right"] += err(out["joints_pred"][:, 1],
                                                out["joints_gt"][:, 1]) * 1000
            self.sums["abs_mpvpe_left"] += err(out["verts_pred"][:, 0],
                                               out["verts_gt"][:, 0]) * 1000
            self.sums["abs_mpvpe_right"] += err(out["verts_pred"][:, 1],
                                                out["verts_gt"][:, 1]) * 1000
            self.sums["off_mpjpe_left"] += err(out["joints_pred_off"][:, 0],
                                               out["joints_gt_off"][:, 0]) * 1000
            self.sums["off_mpjpe_right"] += err(out["joints_pred_off"][:, 1],
                                                out["joints_gt_off"][:, 1]) * 1000
            self.sums["off_mpvpe_left"] += err(out["verts_pred_off"][:, 0],
                                               out["verts_gt_off"][:, 0]) * 1000
            self.sums["off_mpvpe_right"] += err(out["verts_pred_off"][:, 1],
                                                out["verts_gt_off"][:, 1]) * 1000
        if "lms_left_gt" in batch:
            lms_gt = np.stack([batch["lms_left_gt"], batch["lms_right_gt"]], 1)
            per = np.linalg.norm(out["lms21_pred"] - lms_gt,
                                 axis=-1).mean(axis=(1, 2))
            self.sums["lms_px"] += float((per * w).sum())
        self.count += n

        # H2O challenge submission (base_trainer.py:328-335 collects it at
        # bs=1 only; keying rows by their carried id/frame_num makes the
        # batched padded loader produce the identical dict — padded tail
        # rows are excluded by w).
        if "id" in batch:
            ids = np.asarray(batch["id"]).reshape(-1)
            frames = np.asarray(batch["frame_num"]).reshape(-1)
            for i in range(out["joints_pred"].shape[0]):
                if w[i] > 0:
                    self._action_lists.setdefault(int(ids[i]), {})[
                        f"{int(frames[i]):06d}.txt"] = (
                        out["joints_pred"][i].reshape(-1).tolist())

    def result(self) -> Dict[str, float]:
        c = max(self.count, 1)
        return {k: v / c for k, v in self.sums.items()}

    def all_reduce(self) -> "MetricAccumulator":
        """Merge per-process partial accumulators across the ranks of the
        process group.

        With the eval split striped over ranks (loader ``process_index`` /
        ``process_count``, the DistributedSampler role), each rank holds
        the sums over its own records; this sums ``sums``/``count`` in
        float64 in rank order and unions the per-action H2O submission rows
        (stripes are disjoint, so a plain union is exact).  Collective:
        every rank must call it.  The identity without a process group or
        with one rank.  Returns self."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return self
        # pickled Python floats and dicts: exact, whatever the backend
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (
            [self.sums[k] for k in self.KEYS] + [self.count],
            self._action_lists))
        total = np.array([p[0] for p in parts], np.float64).sum(axis=0)
        self.sums = {k: float(total[i]) for i, k in enumerate(self.KEYS)}
        self.count = float(total[len(self.KEYS)])
        merged: Dict[int, Dict] = {}
        for _, rows in parts:
            for action, frames in rows.items():
                merged.setdefault(int(action), {}).update(frames)
        self._action_lists = merged
        return self

    # reference H2O-val.txt line names (base_trainer.py:420-429)
    _REF_NAMES = (("abs_left_joints_loss_all", "abs_mpjpe_left"),
                  ("abs_right_joints_loss_all", "abs_mpjpe_right"),
                  ("abs_left_verts_loss_all", "abs_mpvpe_left"),
                  ("abs_right_verts_loss_all", "abs_mpvpe_right"),
                  ("off_left_joints_loss_all", "off_mpjpe_left"),
                  ("off_right_joints_loss_all", "off_mpjpe_right"),
                  ("off_left_verts_loss_all", "off_mpvpe_left"),
                  ("off_right_verts_loss_all", "off_mpvpe_right"))

    def format_block(self, tag: str = "") -> str:
        """Eval block in the exact reference H2O-val.txt format."""
        r = self.result()
        lines = ["eval "]
        for ref_name, key in self._REF_NAMES:
            lines.append(f"{ref_name}: {r[key]:.2f}")
        return "\n".join(lines) + "\n"

    def write_h2o_submission(self, path: str) -> None:
        sub = dict(self.h2o_submission)
        for action, frames in self._action_lists.items():
            sub[str(action)] = frames
        with open(path, "w") as f:
            json.dump(sub, f)
