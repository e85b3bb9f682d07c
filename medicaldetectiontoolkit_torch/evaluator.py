"""Object- and patient-level evaluation (COCO-style AP, ROC-AUC) of the port.

Counterpart of ``medicaldetectiontoolkit_tpu/evaluator.py`` with no pandas
and no sklearn, giving the same numbers:
  * det<->gt matching per (match_iou x class x patient x batch element) into
    long-format rows with det_type in {det_tp, det_fp, det_fn, patient_tn};
    double assignments keep the max-score candidate, the rest become fp;
  * roi-level AP by COCO's 101-point interpolation, patient-level ROC-AUC /
    AP on the per-pid maximum;
  * results.txt / results_table.txt lines, det-threshold scanning, and the
    tiny perturbation that keeps model selection rankable.

``Evaluator.test_df`` is a ``ResultsTable``: a dict of numpy columns
(pred_score, class_label, pred_class, pid, det_type, fold, match_iou) in the
row order of the JAX package's DataFrame. ``{fold}_test_df.pickle`` is a
plain pickle of that dict (the port's own format, not a pandas pickle).
Row selections keep pandas' order: ``np.unique`` for ``groupby``
(sorted keys), order of first appearance for ``unique()``, and pandas' own
argsort (``nargsort``, numpy quicksort on the reversed column) for
``sort_values(ascending=False)``. ``roc_auc_score``, ``roc_curve``,
``average_precision_score`` and ``precision_recall_curve`` are numpy
versions of scikit-learn's binary ones (stable descending sort, thresholds
at distinct scores, ``drop_intermediate`` as its defaults, float64 counts).
With ``cf.plot_prediction_histograms`` each (class, score level) draws a
prediction histogram, with ``cf.plot_stat_curves`` the ROC and PRC curves,
through the port's ``plotting.py``, under the JAX package's file names;
where matplotlib does not import, ``plotting`` logs that once and draws
nothing.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.integrate import trapezoid

COLUMNS = ("pred_score", "class_label", "pred_class", "pid", "det_type", "fold", "match_iou")


#############################
#  binary metrics (sklearn) #
#############################


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, high to low."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score)
    # stable descending order (ties keep their input order)
    order = y_score.size - 1 - np.flip(np.argsort(np.flip(y_score), kind="stable"))
    y_score, y_true = y_score[order], y_true[order]
    threshold_idxs = np.concatenate([np.nonzero(np.diff(y_score))[0], [y_true.size - 1]])
    tps = np.cumsum(y_true.astype(np.float64))[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score):
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:  # drop collinear points
        keep = np.where(np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score):
    if len(np.unique(y_true)) != 2:
        return np.nan
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(trapezoid(tpr, fpr))  # fpr never decreases


def precision_recall_curve(y_true, y_score):
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([np.flip(precision), [1.0]]), np.concatenate([np.flip(recall), [0.0]]),
            np.flip(thresholds))


def average_precision_score(y_true, y_score):
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


#############################
#       results table       #
#############################


class ResultsTable(dict):
    """The long-format results: a dict of equal-length numpy columns."""

    @property
    def shape(self):
        return (len(self["pid"]), len(self))

    def rows(self, mask):
        return ResultsTable({k: v[mask] for k, v in self.items()})


def _unique_in_order(values):
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def _sort_desc(values):
    """pandas' ``sort_values(ascending=False)`` order of a float column."""
    idx = np.arange(len(values))[::-1]
    return idx[values[::-1].argsort(kind="quicksort")][::-1]


def _iou_matrix(boxes1, boxes2):
    """Plain-IoU matrix (NumPy, matches ops.boxes.pairwise_iou offset 0)."""
    dim = 2 if boxes1.shape[1] == 4 else 3
    inter = np.ones((len(boxes1), len(boxes2)))
    a1 = np.ones(len(boxes1))
    a2 = np.ones(len(boxes2))
    for ax in range(dim):
        lo, hi = (0, 2) if ax == 0 else (1, 3) if ax == 1 else (4, 5)
        seg = np.minimum(boxes1[:, hi][:, None], boxes2[:, hi][None]) - np.maximum(
            boxes1[:, lo][:, None], boxes2[:, lo][None]
        )
        inter *= np.maximum(seg, 0.0)
        a1 *= boxes1[:, hi] - boxes1[:, lo]
        a2 *= boxes2[:, hi] - boxes2[:, lo]
    union = a1[:, None] + a2[None] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


class Evaluator:
    def __init__(self, cf, logger, mode="test"):
        """mode: 'train', 'val_sampling', 'val_patient' or 'test'."""
        self.cf = cf
        self.logger = logger
        self.mode = mode
        self.test_df = None

    def evaluate_predictions(self, results_list, monitor_metrics=None):
        """Match detections to GT and build the long-format results table.

        results_list: train/val_sampling form
        [[[box_lists...], [pids...]], ...] (one entry per batch) or patient
        form [[results, pid], ...].
        """
        rows = {k: [] for k in ("pred_score", "class_label", "pred_class", "pid", "det_type")}
        self.logger.info(f"evaluating in mode {self.mode}")

        if self.mode == "train" or self.mode == "val_sampling":
            batch_elements_list = [[b_box_list] for item in results_list for b_box_list in item[0]]
            pid_list = [pid for item in results_list for pid in item[1]]
        else:
            batch_elements_list = [item[0] for item in results_list]
            pid_list = [item[1] for item in results_list]

        match_iou_col = []
        for match_iou in self.cf.ap_match_ious:
            self.logger.info(f"evaluating with match_iou: {match_iou}")
            for cl in list(self.cf.class_dict.keys()):
                for pix, pid in enumerate(pid_list):
                    len_before_patient = len(rows["pid"])
                    for b_boxes_list in batch_elements_list[pix]:
                        self._match_element(rows, b_boxes_list, cl, pid, match_iou)
                    # true-negative dummy so empty patients stay in patient stats
                    if len(rows["pid"]) == len_before_patient:
                        rows["pred_score"].append(0)
                        rows["class_label"].append(0)
                        rows["pred_class"].append(cl)
                        rows["pid"].append(pid)
                        rows["det_type"].append("patient_tn")
            match_iou_col += [match_iou] * (len(rows["pid"]) - len(match_iou_col))

        n = len(rows["pid"])
        self.test_df = ResultsTable(
            pred_score=np.asarray(rows["pred_score"], dtype=np.float64),
            class_label=np.asarray(rows["class_label"], dtype=np.int64),
            pred_class=np.asarray(rows["pred_class"], dtype=np.int64),
            pid=np.asarray(rows["pid"], dtype=object),
            det_type=np.asarray(rows["det_type"], dtype=object),
            fold=np.asarray([getattr(self.cf, "fold", 0)] * n, dtype=object),
            match_iou=np.asarray(match_iou_col, dtype=np.float64),
        )
        if monitor_metrics is not None:
            return self.return_metrics(monitor_metrics)

    def _match_element(self, rows, b_boxes_list, cl, pid, match_iou):
        """One batch element x one class: emit tp/fp/fn rows.

        A detection matches the GT with its highest IoU if that IoU exceeds
        match_iou; when several detections claim the same GT, only the
        highest-scoring one is a TP (earliest index wins score ties), the
        rest become FPs; unmatched detections are FPs; GTs claimed by no
        detection are FNs (score 0, label 1). Emission order per element:
        demoted FPs, TPs, unmatched FPs, FNs.
        """
        gt_coords, det_coords, det_scores = [], [], []
        for box in b_boxes_list:
            if box["box_type"] == "gt" and box["box_label"] == cl:
                gt_coords.append(box["box_coords"])
            elif box["box_type"] == "det" and box["box_pred_class_id"] == cl:
                det_coords.append(box["box_coords"])
                det_scores.append(box["box_score"])
        n_det, n_gt = len(det_coords), len(gt_coords)
        scores = np.asarray(det_scores)

        def emit(score_values, label, det_type):
            rows["pred_score"] += list(score_values)
            rows["class_label"] += [label] * len(score_values)
            rows["pred_class"] += [cl] * len(score_values)
            rows["pid"] += [pid] * len(score_values)
            rows["det_type"] += [det_type] * len(score_values)

        if n_det == 0:
            if n_gt:
                emit([0] * n_gt, 1, "det_fn")
            return
        if n_gt == 0:
            emit(scores, 0, "det_fp")
            return

        overlaps = _iou_matrix(np.asarray(det_coords), np.asarray(gt_coords))  # (D, G)
        matched = overlaps.max(axis=1) > match_iou
        claimed_gt = overlaps.argmax(axis=1)
        assign = matched[:, None] & (claimed_gt[:, None] == np.arange(n_gt)[None, :])
        # per claimed gt, the highest-scoring claimant wins (argmax -> first
        # max on ties, i.e. lowest det index)
        claimant_scores = np.where(assign, scores[:, None], -np.inf)
        winner_per_gt = claimant_scores.argmax(axis=0)
        is_tp = np.zeros(n_det, bool)
        claimed = assign.any(axis=0)
        is_tp[winner_per_gt[claimed]] = True
        demoted = matched & ~is_tp

        if demoted.any():
            emit(scores[demoted], 0, "det_fp")
        if is_tp.any():
            emit(scores[is_tp], 1, "det_tp")
        if (~matched).any():
            emit(scores[~matched], 0, "det_fp")
        n_fn = int((~claimed).sum())
        if n_fn:
            emit([0] * n_fn, 1, "det_fn")

    # ---- score-level dispatch: one (rows, scores, fold-means) recipe per level

    def _roi_subframe(self, cl_df):
        return cl_df.rows(cl_df["det_type"] != "patient_tn")

    def _patient_subframe(self, cl_df):
        """One row per pid (sorted), the max label and score, the first fold."""
        pids, inverse = np.unique(cl_df["pid"], return_inverse=True)
        labels = np.full(len(pids), np.iinfo(np.int64).min)
        scores = np.full(len(pids), -np.inf)
        np.maximum.at(labels, inverse, cl_df["class_label"])
        np.maximum.at(scores, inverse, cl_df["pred_score"])
        first = np.full(len(pids), len(inverse))
        np.minimum.at(first, inverse, np.arange(len(inverse)))
        return ResultsTable(pid=cl_df["pid"][first], class_label=labels, pred_score=scores,
                            fold=cl_df["fold"][first])

    def _roi_scores(self, spec_df):
        return {
            "ap": get_roi_ap_from_df([spec_df, self.cf.min_det_thresh, self.cf.per_patient_ap]),
            "auc": 0, "roc": None, "prc": None,
        }

    def _patient_scores(self, spec_df):
        """Binary patient-level metrics; a metric is NaN when its input is
        degenerate (single class for AUC/ROC, no positives for AP/PRC)."""
        labels = spec_df["class_label"].tolist()
        scores = spec_df["pred_score"].tolist()
        out = {"auc": np.nan, "roc": np.nan, "ap": np.nan, "prc": np.nan}
        if len(set(labels)) > 1:
            out["auc"] = roc_auc_score(labels, scores)
            out["roc"] = roc_curve(labels, scores)
        if 1 in labels:
            out["ap"] = average_precision_score(labels, scores)
            out["prc"] = precision_recall_curve(labels, scores)
        return out

    def _roi_fold_means(self, spec_df, folds):
        per_fold = [
            get_roi_ap_from_df([spec_df.rows(spec_df["fold"] == f), self.cf.min_det_thresh, self.cf.per_patient_ap])
            for f in folds
        ]
        return {"mean_ap": np.mean(per_fold), "mean_auc": 0}

    def _patient_fold_means(self, spec_df, folds):
        fold_scores = [self._patient_scores(spec_df.rows(spec_df["fold"] == f)) for f in folds]
        valid_aucs = [s["auc"] for s in fold_scores if not np.isnan(s["auc"])]
        valid_aps = [s["ap"] for s in fold_scores if not np.isnan(s["ap"])]
        return {
            "mean_auc": np.mean(valid_aucs) if valid_aucs else np.nan,
            "mean_ap": np.mean(valid_aps) if valid_aps else np.nan,
        }

    _LEVELS = {
        "rois": (_roi_subframe, _roi_scores, _roi_fold_means),
        "patient": (_patient_subframe, _patient_scores, _patient_fold_means),
    }

    def _update_monitor(self, monitor_metrics, level, cl, stats):
        """Append this (level, class) AP, and AUC on patient level, to the
        epoch-series dict. Non-positive / NaN values record as None.
        Patient-level series only track cf.patient_class_of_interest."""
        if level == "patient" and cl != self.cf.patient_class_of_interest:
            return
        series = "patient" if level == "patient" else self.cf.class_dict[cl]
        monitor_metrics[series + "_ap"].append(stats["ap"] if stats["ap"] > 0 else None)
        if level == "patient":
            monitor_metrics[series + "_auc"].append(stats["auc"] if stats["auc"] > 0 else None)

    def _plot_hist(self, spec_df, level, cl):
        from medicaldetectiontoolkit_torch import plotting

        fname = "pred_hist_{}_{}_{}_cl{}".format(
            getattr(self.cf, "fold", 0), "val" if "val" in self.mode else self.mode, level, cl
        )
        plotting.plot_prediction_hist(
            spec_df["class_label"].tolist(),
            spec_df["pred_score"].tolist(),
            spec_df["det_type"].tolist() if level == "rois" else None,
            os.path.join(self.cf.plot_dir, fname),
        )

    def _scan_det_threshs(self, spec_df):
        threshs = list(np.arange(0.9, 1, 0.01))
        with ThreadPoolExecutor(max_workers=10) as pool:
            aps = list(pool.map(get_roi_ap_from_df, [[spec_df, t, self.cf.per_patient_ap] for t in threshs]))
        self.logger.info(f"results from scanning over det_threshs: {[list(p) for p in zip(threshs, aps)]}")

    def _perturb_selection_ties(self, monitor_metrics):
        """Small-dataset val APs tie exactly across epochs; a <=1e-6 jitter on
        a repeated latest value keeps epoch ranking well-defined."""
        for sc in self.cf.model_selection_criteria:
            series = monitor_metrics[sc]
            if "val" in self.mode and series[-1] is not None and series.count(series[-1]) > 1:
                series[-1] += 1e-6 * np.random.rand()

    def return_metrics(self, monitor_metrics=None):
        """AP/AUC per (class x score level); appends to monitor_metrics."""
        df = self.test_df
        folds = _unique_in_order(df["fold"])
        all_stats = []
        for cl in list(self.cf.class_dict.keys()):
            cl_df = df.rows(df["pred_class"] == cl)
            for level in self.cf.report_score_level:
                subframe, scores, fold_means = self._LEVELS[level]
                spec_df = subframe(self, cl_df)
                stats = {"name": f"fold_{getattr(self.cf, 'fold', 0)} {level} cl_{cl}"}
                stats.update(scores(self, spec_df))
                if len(folds) > 1:
                    stats.update(fold_means(self, spec_df, folds))
                all_stats.append(stats)

                if monitor_metrics is not None:
                    self._update_monitor(monitor_metrics, level, cl, stats)
                if self.cf.plot_prediction_histograms:
                    self._plot_hist(spec_df, level, cl)
                if self.cf.scan_det_thresh:
                    self._scan_det_threshs(spec_df)

        if self.cf.plot_stat_curves:
            from medicaldetectiontoolkit_torch import plotting

            out_filename = os.path.join(self.cf.plot_dir, f"{getattr(self.cf, 'fold', 0)}_{self.mode}_stat_curves")
            plotting.plot_stat_curves(all_stats, out_filename)

        # foreground-average summary row over roi-level entries
        roi_rows = [d for d in all_stats if "rois" in d["name"]]
        summary = {"name": "average_foreground_roi", "auc": 0, "ap": np.mean([d["ap"] for d in roi_rows])}
        if len(folds) > 1:
            summary["mean_ap"] = np.mean([d["mean_ap"] for d in roi_rows])
            summary["mean_auc"] = 0
        all_stats.append(summary)

        if monitor_metrics is not None:
            self._perturb_selection_ties(monitor_metrics)

        return all_stats, monitor_metrics

    @staticmethod
    def _stat_line(s, with_means=False, suffix=""):
        if with_means:
            line = "AUC {:0.4f} (mu {:0.4f})  AP {:0.4f} (mu {:0.4f})  {}".format(
                s["auc"], s.get("mean_auc", 0), s["ap"], s.get("mean_ap", 0), s["name"]
            )
            return line + (f" {suffix}" if suffix else "")
        return "AUC {:0.4f}  AP {:0.4f} {}".format(s["auc"], s["ap"], s["name"])

    def _banner(self, handle, title, df_label):
        handle.write("\n****************************\n")
        handle.write(f"\n{title} \n")
        handle.write("\n****************************\n")
        handle.write(f"\n{df_label} {self.test_df.shape}\n  \n")

    def score_test_df(self, internal_df=True):
        """Write fold results to results.txt; aggregate across folds if done."""
        results_path = os.path.join(self.cf.exp_dir, "results.txt")
        if internal_df:
            fold = getattr(self.cf, "fold", 0)
            with open(os.path.join(self.cf.exp_dir, f"{fold}_test_df.pickle"), "wb") as handle:
                pickle.dump(dict(self.test_df), handle)
            stats, _ = self.return_metrics()
            with open(results_path, "a") as handle:
                self._banner(handle, f"results for fold {fold}", "fold df shape")
                for s in stats:
                    handle.write(self._stat_line(s) + " \n")

        fold_dfs = sorted(f for f in os.listdir(self.cf.exp_dir) if "test_df.pickle" in f)
        if len(fold_dfs) != self.cf.n_cv_splits:
            return  # not every fold has finished yet

        # all folds done: rebuild the cross-fold table and emit the overall block
        self.cf.fold = "overall"
        frames = []
        for ix, fname in enumerate(fold_dfs):
            with open(os.path.join(self.cf.exp_dir, fname), "rb") as handle:
                frame = pickle.load(handle)
            frame["fold"] = np.full(len(frame["pid"]), ix, dtype=object)
            frames.append(frame)
        self.test_df = ResultsTable({k: np.concatenate([f[k] for f in frames]) for k in COLUMNS})
        stats, _ = self.return_metrics()

        with open(results_path, "a") as handle:
            self._banner(handle, "OVERALL RESULTS", "df shape")
            for s in stats:
                handle.write("\n" + self._stat_line(s, with_means=True) + "\n ")

        exp_name = os.path.basename(self.cf.exp_dir.rstrip("/"))
        table_path = os.path.join(os.path.dirname(self.cf.exp_dir.rstrip("/")), "results_table.txt")
        with open(table_path, "a") as handle:
            for s in stats:
                handle.write("\n" + self._stat_line(s, with_means=True, suffix=exp_name))
            handle.write("\n")


def _ap_rows(df, det_thresh):
    """(labels of the tp/fp rows above det_thresh, score-sorted) as the JAX
    package selects them: filter, sort descending (pandas' order), threshold."""
    tp_fp = df.rows((df["det_type"] == "det_fp") | (df["det_type"] == "det_tp"))
    tp_fp = tp_fp.rows(_sort_desc(tp_fp["pred_score"]))
    return tp_fp["class_label"][tp_fp["pred_score"] > det_thresh]


def get_roi_ap_from_df(inputs):
    """AP over the roi-level rows (optionally per patient then averaged)."""
    df, det_thresh, per_patient_ap = inputs

    if per_patient_ap:
        pids_list = _unique_in_order(df["pid"])
        aps = []
        for match_iou in _unique_in_order(df["match_iou"]):
            iou_df = df.rows(df["match_iou"] == match_iou)
            for pid in pids_list:
                pid_df = iou_df.rows(iou_df["pid"] == pid)
                all_p = int((pid_df["class_label"] == 1).sum())
                labels = _ap_rows(pid_df, det_thresh)
                if len(labels) == 0 and all_p == 0:
                    pass
                elif len(labels) > 0 and all_p == 0:
                    aps.append(0)
                else:
                    aps.append(compute_roi_ap(labels, all_p))
        return np.mean(aps)

    aps = []
    for match_iou in _unique_in_order(df["match_iou"]):
        iou_df = df.rows(df["match_iou"] == match_iou)
        all_p = int((iou_df["class_label"] == 1).sum())
        labels = _ap_rows(iou_df, det_thresh)
        if all_p > 0:
            aps.append(compute_roi_ap(labels, all_p))
    return np.mean(aps) if aps else 0.0


def compute_roi_ap(tp, all_p):
    """COCO 101-point interpolated AP over score-sorted tp (1) / fp (0) labels."""
    tp = np.asarray(tp)
    fp = (tp == 0) * 1
    recall_thresholds = np.linspace(0.0, 1, 101, endpoint=True)
    tp_sum = np.cumsum(tp)
    fp_sum = np.cumsum(fp)
    rc = tp_sum / all_p
    pr = tp_sum / (fp_sum + tp_sum)

    # precision envelope (monotone non-increasing from the right)
    pr = pr.tolist()
    for i in range(len(pr) - 1, 0, -1):
        if pr[i] > pr[i - 1]:
            pr[i - 1] = pr[i]

    q = np.zeros(len(recall_thresholds))
    inds = np.searchsorted(rc, recall_thresholds, side="left")
    for ri, pi in enumerate(inds):
        if pi < len(pr):
            q[ri] = pr[pi]
    return np.mean(q)
