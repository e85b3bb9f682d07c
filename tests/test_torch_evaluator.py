"""The port's evaluator (no pandas, no sklearn) against the JAX package's
``Evaluator`` on seeded results lists, and its numpy ROC / PR metrics against
scikit-learn's, ties included. All exact: the same rows in the same order,
the same AP / AUC / curves, the same lines in results.txt and
results_table.txt, the same figure calls (prediction histograms, stat
curves) with the same arguments and file names, the same figure files, and
none without matplotlib."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
pd = pytest.importorskip("pandas")
skm = pytest.importorskip("sklearn.metrics")

from medicaldetectiontoolkit_tpu import evaluator as jev  # noqa: E402
from medicaldetectiontoolkit_torch import evaluator as tev  # noqa: E402


class _Log:
    def info(self, *a, **k):
        pass


def _labels_scores(seed, n, ties):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, n)
    labels[:2] = [0, 1]
    scores = rng.rand(n)
    if ties == "coarse":
        scores = np.round(scores, 1)
    elif ties == "all":
        scores[:] = 0.5
    elif ties == "grid":
        scores = rng.randint(0, 4, n) / 4.0
    return labels.tolist(), scores.tolist()


@pytest.mark.parametrize("ties", ["none", "coarse", "all", "grid"])
@pytest.mark.parametrize("seed,n", [(0, 9), (1, 40), (2, 301)])
def test_binary_metrics_match_sklearn(seed, n, ties):
    labels, scores = _labels_scores(seed, n, ties)
    assert tev.roc_auc_score(labels, scores) == skm.roc_auc_score(labels, scores)
    assert tev.average_precision_score(labels, scores) == skm.average_precision_score(labels, scores)
    for ours, theirs in ((tev.roc_curve(labels, scores), skm.roc_curve(labels, scores)),
                         (tev.precision_recall_curve(labels, scores), skm.precision_recall_curve(labels, scores))):
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_binary_metrics_one_class():
    assert np.isnan(tev.roc_auc_score([1, 1, 1], [0.2, 0.4, 0.4]))
    labels, scores = [1, 1, 1], [0.2, 0.4, 0.4]
    assert tev.average_precision_score(labels, scores) == skm.average_precision_score(labels, scores)


def _box(rng, dim, kind, cl, score=None):
    lo = rng.randint(0, 40, dim).astype(float)
    hi = lo + rng.randint(4, 16, dim)
    coords = np.array([lo[0], lo[1], hi[0], hi[1]] + ([lo[2], hi[2]] if dim == 3 else []))
    if kind == "gt":
        return {"box_coords": coords, "box_label": cl, "box_type": "gt"}
    return {"box_coords": coords, "box_score": score, "box_pred_class_id": cl, "box_type": "det"}


def _patient_results(seed, dim=3, n_patients=6):
    """[[boxes per element], pid] per patient: GTs, detections near them
    (tp and demoted fp), stray fps, scores with ties, empty patients."""
    rng = np.random.RandomState(seed)
    results = []
    for p in range(n_patients):
        boxes = []
        if p % 5 != 4:  # some patients hold nothing
            for _ in range(rng.randint(0, 3)):
                gt = _box(rng, dim, "gt", int(rng.randint(1, 3)))
                boxes.append(gt)
                for _ in range(rng.randint(0, 3)):  # near duplicates of the GT
                    det = {"box_coords": gt["box_coords"] + rng.randint(-2, 3, 2 * dim), "box_type": "det",
                           "box_pred_class_id": int(rng.randint(1, 3)), "box_score": float(rng.randint(1, 9) / 8)}
                    boxes.append(det)
            for _ in range(rng.randint(0, 4)):
                boxes.append(_box(rng, dim, "det", int(rng.randint(1, 3)), float(np.round(rng.rand(), 1))))
        results.append([[boxes], f"pid_{(p * 7) % n_patients:02d}"])
    return results


def _cf(exp_dir, fold, per_patient_ap=False, ious=(0.1,), n_cv_splits=2):
    return SimpleNamespace(
        class_dict={1: "benign", 2: "malignant"}, ap_match_ious=list(ious), report_score_level=["patient", "rois"],
        min_det_thresh=0.1, per_patient_ap=per_patient_ap, plot_prediction_histograms=False,
        plot_stat_curves=False, scan_det_thresh=False, patient_class_of_interest=2, fold=fold, exp_dir=exp_dir,
        plot_dir=exp_dir, n_cv_splits=n_cv_splits, model_selection_criteria=["malignant_ap", "benign_ap"],
    )


def _assert_table_matches(table, df):
    assert table.shape == df.shape
    for col in tev.COLUMNS:
        assert table[col].tolist() == df[col].tolist(), col


def _assert_stats_match(ours, theirs):
    assert len(ours) == len(theirs)
    for s, j in zip(ours, theirs):
        assert list(s) == list(j)
        for k in j:
            a, b = s[k], j[k]
            if isinstance(b, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                assert a == b or (a != a and b != b), (s["name"], k, a, b)


@pytest.mark.parametrize("per_patient_ap,ious", [(False, (0.1,)), (True, (0.1,)), (False, (0.1, 0.5))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_matches_jax(tmp_path, seed, per_patient_ap, ious):
    """Two folds scored one after the other: fold lines, then the overall
    block over both folds' pickled tables, and results_table.txt."""
    out = {}
    for name, module in (("jax", jev), ("port", tev)):
        exp_dir = tmp_path / name / "exp"
        os.makedirs(exp_dir)
        for fold in (0, 1):
            cf = _cf(str(exp_dir), fold, per_patient_ap, ious)
            ev = module.Evaluator(cf, _Log(), mode="test")
            ev.evaluate_predictions(_patient_results(seed * 10 + fold))
            out[name, fold] = (ev.test_df, ev.return_metrics()[0])
            ev.score_test_df()
        out[name, "overall"] = (ev.test_df, ev.return_metrics()[0])
        out[name, "files"] = [(tmp_path / name / f).read_text() for f in ("exp/results.txt", "results_table.txt")]
    for key in (0, 1, "overall"):
        _assert_table_matches(out["port", key][0], out["jax", key][0])
        _assert_stats_match(out["port", key][1], out["jax", key][1])
    assert out["port", "files"] == out["jax", "files"]
    assert "OVERALL RESULTS" in out["port", "files"][0]


@pytest.mark.parametrize("seed", [3, 4])
def test_evaluator_monitoring_matches_jax(seed):
    """val_sampling form (batches of elements) with the monitor-metrics
    series updated, the selection tie jitter included."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(3):
        elements = [r[0][0] for r in _patient_results(rng.randint(1000), dim=2, n_patients=4)]
        batches.append([elements, [f"p{rng.randint(6)}" for _ in elements]])
    out = {}
    for module in (jev, tev):
        monitor = {"benign_ap": [None, 0.5], "malignant_ap": [None, 0.25], "patient_ap": [None], "patient_auc": [None]}
        ev = module.Evaluator(_cf("", 0), _Log(), mode="val_sampling")
        np.random.seed(seed)
        stats, monitor = ev.evaluate_predictions(batches, monitor)
        out[module] = (ev.test_df, stats, monitor)
    _assert_table_matches(out[tev][0], out[jev][0])
    _assert_stats_match(out[tev][1], out[jev][1])
    assert out[tev][2] == out[jev][2]


class _Messages:
    def __init__(self):
        self.lines = []

    def info(self, msg, *a, **k):
        self.lines.append(msg)


def test_det_threshold_scan_matches_jax(tmp_path):
    """cf.scan_det_thresh: the AP at thresholds 0.90..0.99, logged. Roi
    level only: on the patient level both packages fail alike (the per-pid
    table has no match_iou column to scan)."""
    logs = {}
    for module in (jev, tev):
        cf = _cf(str(tmp_path), 0)
        cf.scan_det_thresh, cf.report_score_level = True, ["rois"]
        logs[module] = _Messages()
        ev = module.Evaluator(cf, logs[module], mode="test")
        ev.evaluate_predictions(_patient_results(5))
        ev.return_metrics()
    scans = [[m for m in logs[mod].lines if "scanning" in m] for mod in (jev, tev)]
    assert len(scans[1]) == 2 and scans[1] == scans[0]


def _recorded_figures(monkeypatch, plotting, calls):
    """Record the evaluator's figure calls of ``plotting`` in ``calls``."""
    monkeypatch.setattr(plotting, "plot_prediction_hist", lambda *args: calls.append(("hist", args)))
    monkeypatch.setattr(plotting, "plot_stat_curves", lambda stats, outfile: calls.append(("curves", stats, outfile)))


@pytest.mark.parametrize("mode,fold", [("test", 0), ("val_patient", 1), ("train", 0)])
def test_figure_calls_match_jax(tmp_path, monkeypatch, mode, fold):
    """With prediction histograms and stat curves on: the same figures
    under the same file names, each histogram with the same labels, scores
    and detection types, the curves with the same stats."""
    from medicaldetectiontoolkit_torch import plotting as tplot
    from medicaldetectiontoolkit_tpu import plotting as jplot

    calls = {}
    for name, module, plotting in (("jax", jev, jplot), ("port", tev, tplot)):
        calls[name] = []
        _recorded_figures(monkeypatch, plotting, calls[name])
        cf = _cf(str(tmp_path), fold)
        cf.plot_prediction_histograms = cf.plot_stat_curves = True
        ev = module.Evaluator(cf, _Log(), mode=mode)
        if mode == "train":
            batches = [[[r[0][0] for r in _patient_results(9, n_patients=3)], ["a", "b", "c"]]]
            ev.evaluate_predictions(batches)
        else:
            ev.evaluate_predictions(_patient_results(8 + fold))
        ev.return_metrics()
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]] == ["hist"] * 4 + ["curves"]
    for ours, theirs in zip(calls["port"][:4], calls["jax"][:4]):
        assert ours == theirs
    _, stats, outfile = calls["port"][4]
    _assert_stats_match(stats, calls["jax"][4][1])
    assert outfile == calls["jax"][4][2] == os.path.join(str(tmp_path), f"{fold}_{mode}_stat_curves")
    names = [os.path.basename(c[1][3]) for c in calls["port"][:4]]
    kind = "val" if "val" in mode else mode
    assert names == [f"pred_hist_{fold}_{kind}_{level}_cl{cl}" for cl in (1, 2) for level in ("patient", "rois")]


def test_figures_written_as_jax_writes_them(tmp_path):
    """Drawn with matplotlib: the same files as the JAX package's."""
    pytest.importorskip("matplotlib")
    files = {}
    for name, module in (("jax", jev), ("port", tev)):
        plot_dir = tmp_path / name
        os.makedirs(plot_dir)
        cf = _cf(str(plot_dir), 0)
        cf.plot_prediction_histograms = cf.plot_stat_curves = True
        ev = module.Evaluator(cf, _Log(), mode="test")
        ev.evaluate_predictions(_patient_results(6))
        ev.return_metrics()
        files[name] = sorted(os.listdir(plot_dir))
    assert files["port"] == files["jax"] and len(files["port"]) == 6


def test_no_figures_without_matplotlib(tmp_path, monkeypatch, caplog):
    """Where matplotlib does not import (the card's machine): no file, one
    warning, and the scores as with figures off."""
    import logging
    import sys

    from medicaldetectiontoolkit_torch import plotting as tplot

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tplot._pyplot.cache_clear()
    try:
        stats = []
        for figures in (True, False):
            cf = _cf(str(tmp_path), 0)
            cf.plot_prediction_histograms = cf.plot_stat_curves = figures
            ev = tev.Evaluator(cf, _Log(), mode="test")
            with caplog.at_level(logging.WARNING, logger=tplot.__name__):
                for seed in (6, 7):
                    ev.evaluate_predictions(_patient_results(seed))
                    stats.append(ev.return_metrics()[0])
    finally:
        tplot._pyplot.cache_clear()
    assert os.listdir(tmp_path) == []
    warnings = [r for r in caplog.records if r.name == tplot.__name__]
    assert len(warnings) == 1 and "matplotlib" in warnings[0].getMessage()
    _assert_stats_match(stats[0], stats[2])
    _assert_stats_match(stats[1], stats[3])
