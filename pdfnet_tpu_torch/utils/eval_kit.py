"""FreiHAND-style evaluation kit: alignment + PCK/AUC curves + scorer (a
copy of ``pdfnet_tpu/utils/eval_kit.py``, numpy only, kept in the port's
namespace because the port imports nothing of the JAX package).

Reference: lib/utils/eval.py:75-404 (align_w_scale, scale/trans alignment,
main() scorer, createHTML report) and lib/utils/eval_util.py:4-94
(EvalUtil).  Used for cross-dataset evaluation protocols
(FreiHAND/HO3D-style aligned metrics).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def align_w_scale(mtx1: np.ndarray, mtx2: np.ndarray,
                  return_trafo: bool = False):
    """Procrustes: align mtx2 to mtx1 with rotation + scale + translation."""
    t1 = mtx1.mean(0)
    t2 = mtx2.mean(0)
    mtx1_t = mtx1 - t1
    mtx2_t = mtx2 - t2
    s1 = np.linalg.norm(mtx1_t) + 1e-8
    s2 = np.linalg.norm(mtx2_t) + 1e-8
    mtx1_t = mtx1_t / s1
    mtx2_t = mtx2_t / s2
    u, w, vt = np.linalg.svd(mtx2_t.T @ mtx1_t)
    R = (u @ vt).T
    scale = w.sum() * s1
    if return_trafo:
        return R, scale, s2, t1, t2
    return mtx2_t @ R.T * scale + t1


def align_by_trafo(mtx: np.ndarray, trafo) -> np.ndarray:
    """Apply a recorded alignment to another point set (e.g. verts)."""
    R, scale, s2, t1, t2 = trafo
    return (mtx - t2) / s2 @ R.T * scale + t1


def align_sc_tr(mtx1: np.ndarray, mtx2: np.ndarray) -> np.ndarray:
    """Scale + translation (no rotation) alignment of mtx2 to mtx1, exactly
    as the reference protocol defines it (eval.py:75-93): the scale is the
    ratio of the |joint4 - joint0| bone lengths (not a Frobenius-norm fit)
    and the translation pins the wrist (row 0) to the ground truth wrist."""
    pred = np.asarray(mtx2).copy()
    s = np.sqrt(np.sum(np.square(pred[4] - pred[0])))
    if s > 0:
        pred = pred / s
    s_gt = np.sqrt(np.sum(np.square(mtx1[4] - mtx1[0])))
    pred = pred * s_gt
    return (pred - pred[0:1, :]) + mtx1[0:1, :]


class EvalUtil:
    """Accumulates keypoint errors; produces PCK curves, AUC, mean/median."""

    def __init__(self, num_kp: int = 21):
        self.data: List[List[float]] = [[] for _ in range(num_kp)]
        self.num_kp = num_kp

    def feed(self, keypoint_gt: np.ndarray, keypoint_vis: np.ndarray,
             keypoint_pred: np.ndarray) -> None:
        keypoint_gt = np.squeeze(keypoint_gt)
        keypoint_pred = np.squeeze(keypoint_pred)
        keypoint_vis = np.squeeze(keypoint_vis).astype(bool)
        dist = np.linalg.norm(keypoint_gt - keypoint_pred, axis=-1)
        for i in range(self.num_kp):
            if keypoint_vis[i]:
                self.data[i].append(float(dist[i]))

    def _pck(self, kp_id: int, threshold: float) -> float:
        d = np.asarray(self.data[kp_id])
        if len(d) == 0:
            return float("nan")
        return float((d <= threshold).mean())

    def get_measures(self, val_min: float, val_max: float, steps: int):
        """Returns (mean, median, auc, pck_curve_all, thresholds).

        Aggregation matches the reference exactly (eval_util.py:53-94):
        ``mean``/``median`` are the mean over keypoints of the per-keypoint
        mean/median (NOT statistics of the pooled distances — with unequal
        per-keypoint counts these differ), AUC is the mean of per-keypoint
        trapezoid areas, and keypoints with no fed samples are skipped from
        all three.
        """
        thresholds = np.linspace(val_min, val_max, steps)
        norm = np.trapezoid(np.ones_like(thresholds), thresholds)

        means, medians, aucs, pck_curves = [], [], [], []
        for kp in range(self.num_kp):
            d = np.asarray(self.data[kp])
            if len(d) == 0:
                continue
            means.append(d.mean())
            medians.append(np.median(d))
            pck = np.array([self._pck(kp, t) for t in thresholds])
            pck_curves.append(pck)
            aucs.append(np.trapezoid(pck, thresholds) / norm)
        pck_all = np.mean(np.stack(pck_curves), axis=0)
        return (float(np.mean(means)), float(np.mean(medians)),
                float(np.mean(aucs)), pck_all, thresholds)


# ---------------------------------------------------------------------------
# Full-dataset scorer (reference lib/utils/eval.py:205-383 ``main``)
# ---------------------------------------------------------------------------

@dataclass
class Curve:
    """One PCK/PCV curve for the HTML report (eval.py:127-135)."""
    x_data: np.ndarray
    y_data: np.ndarray
    x_label: str
    y_label: str
    text: str


def _svg_curve(c: Curve, width: int = 576, height: int = 432) -> str:
    """Render a curve as a self-contained inline SVG (no matplotlib/tmp-PNG
    round-trip as in the reference; the report stays a single file)."""
    m = 56  # margin for axes/labels
    x = np.asarray(c.x_data, np.float64)
    y = np.asarray(c.y_data, np.float64)
    ok = np.isfinite(x) & np.isfinite(y)
    x, y = x[ok], y[ok]
    if x.size == 0:
        return f"<svg width='{width}' height='{height}'></svg>"
    x0, x1 = float(x.min()), float(x.max())
    y0, y1 = 0.0, max(1.0, float(y.max()))
    sx = lambda v: m + (v - x0) / max(x1 - x0, 1e-12) * (width - 2 * m)
    sy = lambda v: height - m - (v - y0) / max(y1 - y0, 1e-12) * (height - 2 * m)
    pts = " ".join(f"{sx(a):.1f},{sy(b):.1f}" for a, b in zip(x, y))
    ticks = []
    for t in np.linspace(x0, x1, 6):
        ticks.append(f"<text x='{sx(t):.0f}' y='{height - m + 18}' "
                     f"font-size='11' text-anchor='middle'>{t:.2g}</text>")
    for t in np.linspace(y0, y1, 6):
        ticks.append(f"<text x='{m - 6}' y='{sy(t):.0f}' font-size='11' "
                     f"text-anchor='end'>{t:.2g}</text>")
    return (
        f"<svg width='{width}' height='{height}' "
        f"xmlns='http://www.w3.org/2000/svg'>"
        f"<rect width='{width}' height='{height}' fill='white'/>"
        f"<line x1='{m}' y1='{height - m}' x2='{width - m}' "
        f"y2='{height - m}' stroke='black'/>"
        f"<line x1='{m}' y1='{m}' x2='{m}' y2='{height - m}' stroke='black'/>"
        f"<polyline points='{pts}' fill='none' stroke='#3366cc' "
        f"stroke-width='2'/>"
        f"<text x='{width / 2:.0f}' y='{height - 12}' font-size='13' "
        f"text-anchor='middle'>{c.x_label}</text>"
        f"<text x='16' y='{height / 2:.0f}' font-size='13' "
        f"text-anchor='middle' transform='rotate(-90 16 {height / 2:.0f})'>"
        f"{c.y_label}</text>"
        + "".join(ticks) + "</svg>")


def create_html_report(output_dir: str, curves: Sequence[Curve],
                       filename: str = "scores2.html") -> str:
    """Write the detailed-results HTML page (eval.py:138-180); curves are
    embedded as inline SVG instead of base64 PNGs."""
    os.makedirs(output_dir, exist_ok=True)
    parts = ["<!DOCTYPE html>", "<html>", "<body>",
             "<h1>Detailed results:</h1>"]
    for c in curves:
        parts += [f"<h2>{c.text}</h2>", "<p>", _svg_curve(c), "</p>",
                  "<p>Raw curve data:</p>",
                  f"<p>x_axis: <small>{np.asarray(c.x_data).tolist()}</small></p>",
                  f"<p>y_axis: <small>{np.asarray(c.y_data).tolist()}</small></p>"]
    parts += ["</body>", "</html>"]
    path = os.path.join(output_dir, filename)
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


def calculate_fscore(gt: np.ndarray, pred: np.ndarray,
                     threshold: float) -> Tuple[float, float, float]:
    """Point-cloud F-score at a distance threshold (the reference declares
    f_threshs=[0.005, 0.015] but leaves the computation commented out,
    eval.py:301-307; implemented here for completeness).  Exact
    nearest-neighbour over 778-vertex meshes."""
    d2 = ((gt[:, None, :] - pred[None, :, :]) ** 2).sum(-1)
    recall = float((d2.min(axis=1) <= threshold ** 2).mean())
    precision = float((d2.min(axis=0) <= threshold ** 2).mean())
    f = (2 * recall * precision / (recall + precision)
         if recall + precision > 0 else 0.0)
    return f, precision, recall


def score_predictions(gt_xyz_list, gt_verts_list, pred_xyz_list,
                      pred_verts_list, output_dir: Optional[str] = None,
                      f_threshs: Sequence[float] = (0.005, 0.015),
                      f_scores: bool = True,
                      ) -> Dict[str, float]:
    """FreiHAND-protocol scorer (reference eval.py:205-383 ``main``).

    Computes raw / Procrustes-aligned / scale-translation-aligned keypoint
    errors and mesh errors, writes ``scores.txt`` with the same keys as the
    reference and the HTML curve report.  Inputs are sequences of (21, 3)
    xyz and (778, 3) verts arrays in meters.  ``scores.txt`` is opened in
    append mode like the reference (eval.py:352), so repeated runs into one
    output_dir accumulate blocks; use a fresh dir per run if a single-block
    file is required.

    ``f_scores``: the reference declares f_threshs but leaves the F-score
    computation commented out (eval.py:301-307), so its scores.txt carries
    exactly the 10 keypoint/mesh keys.  We compute real F-scores by default
    (beyond parity); pass ``f_scores=False`` for a reference-identical key
    set.  The 10 shared keys are numerically identical either way,
    including the reference's quirk of writing ``-100.0`` (−1 × the cm
    conversion, eval.py:353-366) for the mesh means when predictions are
    not MANO-topology.
    """
    assert len(gt_xyz_list) == len(pred_xyz_list), "Expected format mismatch."
    assert len(gt_verts_list) == len(pred_verts_list), \
        "Expected format mismatch."

    eval_xyz, eval_xyz_pa, eval_xyz_sc = EvalUtil(), EvalUtil(), EvalUtil()
    eval_mesh, eval_mesh_al = EvalUtil(num_kp=778), EvalUtil(num_kp=778)
    f_score = [[] for _ in f_threshs]
    f_score_al = [[] for _ in f_threshs]
    # Latched on the first sample, exactly like the reference (eval.py:257).
    shape_is_mano: Optional[bool] = None

    for xyz, verts, xyz_pred, verts_pred in zip(
            gt_xyz_list, gt_verts_list, pred_xyz_list, pred_verts_list):
        xyz, verts = np.asarray(xyz), np.asarray(verts)
        xyz_pred, verts_pred = np.asarray(xyz_pred), np.asarray(verts_pred)
        vis21 = np.ones_like(xyz[:, 0])
        vis778 = np.ones_like(verts[:, 0])
        if shape_is_mano is None:
            shape_is_mano = verts_pred.shape[0] == verts.shape[0]

        eval_xyz.feed(xyz, vis21, xyz_pred)
        eval_xyz_sc.feed(xyz, vis21, align_sc_tr(xyz, xyz_pred))
        xyz_pred_al = align_w_scale(xyz, xyz_pred)
        eval_xyz_pa.feed(xyz, vis21, xyz_pred_al)

        if shape_is_mano:
            verts_pred_al = align_w_scale(verts, verts_pred)
            eval_mesh.feed(verts, vis778, verts_pred)
            eval_mesh_al.feed(verts, vis778, verts_pred_al)
        else:
            trafo = align_w_scale(xyz, xyz_pred, return_trafo=True)
            verts_pred_al = align_by_trafo(verts_pred, trafo)
        if f_scores:
            for i, t in enumerate(f_threshs):
                f_score[i].append(calculate_fscore(verts, verts_pred, t)[0])
                f_score_al[i].append(
                    calculate_fscore(verts, verts_pred_al, t)[0])

    xyz_m, _, xyz_auc, pck_xyz, th = eval_xyz.get_measures(0.0, 0.05, 100)
    pa_m, _, pa_auc, pck_pa, th_pa = eval_xyz_pa.get_measures(0.0, 0.05, 100)
    sc_m, _, sc_auc, pck_sc, th_sc = eval_xyz_sc.get_measures(0.0, 0.05, 100)
    if shape_is_mano and eval_mesh.data[0]:
        mesh_m, _, mesh_auc, pck_mesh, th_mesh = \
            eval_mesh.get_measures(0.0, 0.05, 100)
        mal_m, _, mal_auc, pck_mal, th_mal = \
            eval_mesh_al.get_measures(0.0, 0.05, 100)
    else:
        mesh_m = mesh_auc = mal_m = mal_auc = -1.0
        pck_mesh = pck_mal = np.array([-1.0, -1.0])
        th_mesh = th_mal = np.array([0.0, 1.0])

    # scores.txt with the reference's exact keys and unit conversions
    # (cm via unconditional ×100, eval.py:350-371)
    scores = {
        "xyz_mean3d": xyz_m * 100, "xyz_auc3d": xyz_auc,
        "xyz_procrustes_al_mean3d": pa_m * 100,
        "xyz_procrustes_al_auc3d": pa_auc,
        "xyz_scale_trans_al_mean3d": sc_m * 100,
        "xyz_scale_trans_al_auc3d": sc_auc,
        "mesh_mean3d": mesh_m * 100,
        "mesh_auc3d": mesh_auc,
        "mesh_al_mean3d": mal_m * 100,
        "mesh_al_auc3d": mal_auc,
    }
    if f_scores:
        for i, t in enumerate(f_threshs):
            scores[f"f_score_{round(t * 1000)}"] = float(np.mean(f_score[i]))
            scores[f"f_al_score_{round(t * 1000)}"] = \
                float(np.mean(f_score_al[i]))

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "scores.txt"), "a") as f:
            for k, v in scores.items():
                f.write(f"{k}: {v:f}\n")
        create_html_report(output_dir, [
            Curve(th * 100, pck_xyz, "Distance in cm",
                  "Percentage of correct keypoints",
                  "PCK curve for aligned keypoint error"),
            Curve(th_pa * 100, pck_pa, "Distance in cm",
                  "Percentage of correct keypoints",
                  "PCK curve for procrustes aligned keypoint error"),
            Curve(th_sc * 100, pck_sc, "Distance in cm",
                  "Percentage of correct keypoints",
                  "PCK curve for scale-translation aligned keypoint error"),
            Curve(th_mesh * 100, pck_mesh, "Distance in cm",
                  "Percentage of correct vertices",
                  "PCV curve for mesh error"),
            Curve(th_mal * 100, pck_mal, "Distance in cm",
                  "Percentage of correct vertices",
                  "PCV curve for aligned mesh error"),
        ])
    return scores


def score_prediction_files(gt_path: str, pred_file: str, output_dir: str,
                           set_name: str = "evaluation") -> Dict[str, float]:
    """File-based entry matching the reference CLI (eval.py:388-404):
    ``{gt_path}/{set_name}_xyz.json`` + ``_verts.json`` ground truth and a
    ``pred.json`` holding ``[xyz_list, verts_list]``."""
    with open(os.path.join(gt_path, f"{set_name}_xyz.json")) as f:
        gt_xyz = json.load(f)
    with open(os.path.join(gt_path, f"{set_name}_verts.json")) as f:
        gt_verts = json.load(f)
    with open(pred_file) as f:
        pred = json.load(f)
    assert len(pred) == 2, "Expected format mismatch."
    return score_predictions(gt_xyz, gt_verts, pred[0], pred[1], output_dir)
