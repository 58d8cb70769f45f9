"""The port's FreiHAND eval kit (``pdfnet_tpu_torch.utils.eval_kit``)
against the JAX package's (``pdfnet_tpu.utils.eval_kit``) on the same
seeded inputs: every function, the written ``scores.txt`` and HTML report
included.  Both are numpy code run in the same order, so the results are
required to be equal, not close: a copy that drifts (a changed key, unit,
alignment or aggregation) fails here."""

import json
import os

import numpy as np
import pytest

from pdfnet_tpu.utils import eval_kit as jax_kit

from pdfnet_tpu_torch.utils import eval_kit as port_kit


def _hands(seed, n, verts=778):
    """n (21, 3) joint sets and (verts, 3) meshes in meters, and noisy,
    rotated, scaled and shifted predictions of them."""
    rng = np.random.RandomState(seed)
    gt_xyz = [rng.randn(21, 3) * 0.05 + [0, 0, 0.5] for _ in range(n)]
    gt_verts = [rng.randn(778, 3) * 0.05 + [0, 0, 0.5] for _ in range(n)]
    th = rng.uniform(-0.4, 0.4, n)
    R = [np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                   [0, 0, 1]]) for t in th]
    s = rng.uniform(0.8, 1.2, n)
    sh = rng.randn(n, 3) * 0.01
    pred_xyz = [s[i] * g @ R[i].T + sh[i] + rng.randn(21, 3) * 0.004
                for i, g in enumerate(gt_xyz)]
    pred_verts = [s[i] * g[:verts] @ R[i].T + sh[i]
                  + rng.randn(verts, 3) * 0.004
                  for i, g in enumerate(gt_verts)]
    return gt_xyz, gt_verts, pred_xyz, pred_verts


def test_alignments_equal():
    gt, _, pred, _ = _hands(0, 4)
    for a, b in zip(gt, pred):
        np.testing.assert_array_equal(port_kit.align_w_scale(a, b),
                                      jax_kit.align_w_scale(a, b))
        tj = jax_kit.align_w_scale(a, b, return_trafo=True)
        tp = port_kit.align_w_scale(a, b, return_trafo=True)
        for x, y in zip(tp, tj):
            np.testing.assert_array_equal(x, y)
        mesh = np.random.RandomState(1).randn(778, 3)
        np.testing.assert_array_equal(port_kit.align_by_trafo(mesh, tp),
                                      jax_kit.align_by_trafo(mesh, tj))
        np.testing.assert_array_equal(port_kit.align_sc_tr(a, b),
                                      jax_kit.align_sc_tr(a, b))


def test_align_sc_tr_keeps_the_bone_length_scale():
    """The reference's quirk: the scale is the |joint4 - joint0| bone
    ratio, and a zero bone leaves the prediction unscaled."""
    gt, _, pred, _ = _hands(2, 1)
    p = pred[0].copy()
    out = port_kit.align_sc_tr(gt[0], p)
    np.testing.assert_allclose(np.linalg.norm(out[4] - out[0]),
                               np.linalg.norm(gt[0][4] - gt[0][0]))
    np.testing.assert_array_equal(out[0], gt[0][0])
    p[4] = p[0]
    np.testing.assert_array_equal(port_kit.align_sc_tr(gt[0], p),
                                  jax_kit.align_sc_tr(gt[0], p))


@pytest.mark.parametrize("num_kp", [21, 778])
def test_eval_util_equal(num_kp):
    """Unequal per-keypoint counts (visibility masks) and one keypoint never
    fed: mean, median, AUC, the PCK curve and thresholds all equal."""
    rng = np.random.RandomState(num_kp)
    ej, ep = jax_kit.EvalUtil(num_kp), port_kit.EvalUtil(num_kp)
    for _ in range(5):
        gt = rng.randn(num_kp, 3) * 0.05
        pred = gt + rng.randn(num_kp, 3) * 0.01
        vis = rng.rand(num_kp) > 0.3
        vis[3] = False
        ej.feed(gt, vis, pred)
        ep.feed(gt, vis, pred)
    assert ep.data == ej.data
    for a, b in zip(ep.get_measures(0.0, 0.05, 100),
                    ej.get_measures(0.0, 0.05, 100)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("x,y", [
    (np.linspace(0, 5, 100), np.linspace(0, 1, 100) ** 2),
    (np.array([0.0, 1.0]), np.array([-1.0, -1.0])),
    (np.array([np.nan, np.inf]), np.array([1.0, 2.0]))])
def test_svg_curve_equal(x, y):
    args = (x, y, "Distance in cm", "PCK", "title")
    assert (port_kit._svg_curve(port_kit.Curve(*args))
            == jax_kit._svg_curve(jax_kit.Curve(*args)))


def test_html_report_equal(tmp_path):
    x, y = np.linspace(0, 5, 50), np.linspace(0, 1, 50)
    pj = jax_kit.create_html_report(str(tmp_path / "j"), [
        jax_kit.Curve(x, y, "a", "b", "c"), jax_kit.Curve(x, y ** 3, "d", "e",
                                                          "f")])
    pp = port_kit.create_html_report(str(tmp_path / "p"), [
        port_kit.Curve(x, y, "a", "b", "c"), port_kit.Curve(x, y ** 3, "d",
                                                            "e", "f")])
    assert os.path.basename(pp) == os.path.basename(pj) == "scores2.html"
    assert open(pp).read() == open(pj).read()


@pytest.mark.parametrize("thresh", [0.005, 0.015, 1e-6])
def test_fscore_equal(thresh):
    _, gt, _, pred = _hands(3, 1)
    assert (port_kit.calculate_fscore(gt[0], pred[0], thresh)
            == jax_kit.calculate_fscore(gt[0], pred[0], thresh))


@pytest.mark.parametrize("verts,f_scores", [(778, True), (778, False),
                                            (700, True)])
def test_score_predictions_equal(tmp_path, verts, f_scores):
    """MANO-topology predictions and not (the -100.0 mesh keys), with and
    without F-scores; two calls into one directory append two blocks to
    ``scores.txt``, as the reference does."""
    data = _hands(4, 3, verts)
    for _ in range(2):
        sj = jax_kit.score_predictions(*data, output_dir=str(tmp_path / "j"),
                                       f_scores=f_scores)
        sp = port_kit.score_predictions(*data,
                                        output_dir=str(tmp_path / "p"),
                                        f_scores=f_scores)
    assert sp == sj
    assert len(sp) == (14 if f_scores else 10)
    if verts != 778:
        assert sp["mesh_mean3d"] == sp["mesh_al_mean3d"] == -100.0
    for name in ("scores.txt", "scores2.html"):
        got = open(tmp_path / "p" / name).read()
        assert got == open(tmp_path / "j" / name).read(), name
    assert open(tmp_path / "p" / "scores.txt").read().count("xyz_auc3d") == 2


def test_score_prediction_files_equal(tmp_path):
    gt_xyz, gt_verts, pred_xyz, pred_verts = _hands(5, 2)
    lists = lambda arrs: [a.tolist() for a in arrs]
    with open(tmp_path / "evaluation_xyz.json", "w") as f:
        json.dump(lists(gt_xyz), f)
    with open(tmp_path / "evaluation_verts.json", "w") as f:
        json.dump(lists(gt_verts), f)
    with open(tmp_path / "pred.json", "w") as f:
        json.dump([lists(pred_xyz), lists(pred_verts)], f)
    sj = jax_kit.score_prediction_files(str(tmp_path), str(tmp_path /
                                                           "pred.json"),
                                        str(tmp_path / "j"))
    sp = port_kit.score_prediction_files(str(tmp_path), str(tmp_path /
                                                            "pred.json"),
                                         str(tmp_path / "p"))
    assert sp == sj
    assert (open(tmp_path / "p" / "scores.txt").read()
            == open(tmp_path / "j" / "scores.txt").read())
