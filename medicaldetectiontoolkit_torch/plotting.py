"""Monitoring plots of the port: batch predictions, training curves,
histograms, ROC/PRC.

Counterpart of ``medicaldetectiontoolkit_tpu/plotting.py``, whole, with the
same figures and file names:
  * ``plot_batch_prediction``: input/GT/prediction grids; 3D volumes are
    shown as slice strips around a GT box;
  * ``TrainingPlot2Panel``: per-epoch loss/metric curves;
  * prediction histograms and ROC/PRC curves (the evaluator does not draw
    them yet).

matplotlib is imported inside the functions only, at the first figure.
Where it does not import (the card's machine has none), the first figure
logs that once and no figure is written; the training loop goes on.
"""

from __future__ import annotations

import functools
import logging
import os
from copy import deepcopy

import numpy as np


@functools.lru_cache(maxsize=None)
def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (logged once) where
    matplotlib does not import."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        logging.getLogger(__name__).warning(f"matplotlib does not import ({e}): no figures are written")
        return None
    return plt


def _unroll_3d_patient(data, segs, seg_preds, element_boxes, pid):
    """Turn one 3D patient into a z-major slice batch windowed around its
    first GT box (±5 slices; image center if no GT). Boxes are flattened to
    their in-plane coords and repeated on every slice they span."""
    data = np.moveaxis(data, -1, 0)  # (z, c, y, x)
    segs = np.moveaxis(segs, -1, 0)
    seg_preds = np.moveaxis(seg_preds, -1, 0)
    n_z = data.shape[0]

    gt_z = [b["box_coords"][4:6] for b in element_boxes if b["box_type"] == "gt"]
    if gt_z:
        lo, hi = max(int(gt_z[0][0]) - 5, 0), min(int(gt_z[0][1]) + 5, n_z)
    else:
        lo = max(n_z // 2 - 5, 0)
        hi = n_z // 2 + min(10, n_z // 2)

    per_slice = [[] for _ in range(n_z)]
    for box in element_boxes:
        c = box["box_coords"]
        flat = dict(box, box_coords=np.asarray(c[:4], dtype=float))
        z_from = int(np.clip(np.round(c[4]), 0, n_z - 1))
        z_to = int(np.clip(np.round(c[5]), 0, n_z - 1))
        for z in range(z_from, z_to + 1):
            per_slice[z].append(flat)

    return data[lo:hi], segs[lo:hi], seg_preds[lo:hi], per_slice[lo:hi], [pid] * (hi - lo)


def _overlay_boxes(ax, boxes, with_dets, cf):
    """Draw box outlines (+ class/score annotations) onto one axes."""
    from matplotlib.patches import Rectangle

    for box in boxes:
        kind = box["box_type"]
        if kind == "patient_tn_box":
            continue
        c = box["box_coords"]
        annotation = None
        if kind == "det":
            if not (with_dets and box["box_pred_class_id"] > 0 and box["box_score"] > 0.1):
                continue
            annotation = (
                c[1] + 10 * (box["box_pred_class_id"] - 1),
                c[2] + 5,
                f"{box['box_pred_class_id']}|{np.max(box['box_score']) * 100:.0f}",
                "w",
            )
        elif kind == "gt":
            annotation = (c[1], c[0] - 1, int(box["box_label"]), "r")
        ax.add_patch(
            Rectangle(
                (c[1], c[0]), c[3] - c[1], c[2] - c[0],
                fill=False, edgecolor=cf.box_color_palette[kind], linewidth=1,
            )
        )
        if annotation is not None:
            x, y, text, color = annotation
            ax.text(x, y, text, fontsize=7, color=color)


def plot_batch_prediction(batch, results_dict, cf, outfile=None):
    """Monitoring grid: one column per batch element (or z-slice in 3D), rows
    = data channels, GT seg, predicted seg, data-with-boxes overlay. Same
    artifact as the reference's example-prediction plot (``plotting.py:26-158``)."""
    plt = _pyplot()
    if plt is None:
        return
    if outfile is None:
        outfile = os.path.join(cf.plot_dir, f"pred_example_{cf.fold}.png")

    data, segs, seg_preds = batch["data"], batch["seg"], results_dict["seg_preds"]
    boxes_per_element = deepcopy(results_dict["boxes"])
    pids = batch["pid"]
    if len(set(map(str, np.atleast_1d(pids)))) == 1:
        pids = [pids] * data.shape[0]

    if cf.dim == 3:
        p = np.random.choice(data.shape[0])
        data, segs, seg_preds, boxes_per_element, pids = _unroll_3d_patient(
            data[p], segs[p], seg_preds[p], boxes_per_element[p], pids[p]
        )

    assert data.shape[0] == segs.shape[0] == seg_preds.shape[0], (data.shape, segs.shape, seg_preds.shape)
    assert data.shape[2:] == segs.shape[2:] == seg_preds.shape[2:], (data.shape, segs.shape, seg_preds.shape)

    n_cols = data.shape[0]
    n_chan = data.shape[1]
    n_rows = n_chan + 3  # channels, gt seg, pred seg, overlay
    fig, axes = plt.subplots(
        n_rows, n_cols, figsize=(4 * n_cols, 4 * n_rows), squeeze=False,
        gridspec_kw={"wspace": 0.1, "hspace": 0.1},
    )
    for col in range(n_cols):
        axes[0, col].set_title(f"{str(pids[col])[:10]}", fontsize=20)
        rows = (
            [(data[col, ch], "gray", None, None, False, False) for ch in range(n_chan)]
            + [
                (segs[col, 0], None, 0, cf.num_seg_classes - 1, True, False),
                (seg_preds[col, 0], None, 0, cf.num_seg_classes - 1, True, True),
                (data[col, 0], "gray", None, None, True, False),
            ]
        )
        for row, (img, cmap, vmin, vmax, with_boxes, with_dets) in enumerate(rows):
            ax = axes[row, col]
            ax.axis("off")
            ax.imshow(np.asarray(img, dtype=float), cmap=cmap, vmin=vmin, vmax=vmax)
            if with_boxes:
                _overlay_boxes(ax, boxes_per_element[col], with_dets, cf)

    fig.savefig(outfile)
    plt.close(fig)


_MONITOR_PALETTE = ["b", "c", "r", "purple", "m", "y", "k", "tab:gray"]
# (split, linestyle) per curve family: train dashed, val solid — the artifact
# contract every downstream reader of monitor_*.png expects
_MONITOR_SPLITS = (("train", "--"), ("val", "-"))


def _series_for_key(metrics, split, key, epochs):
    """Epoch series for one monitored quantity.

    Loss-like keys live directly in metrics[split] (one value per epoch,
    slot 0 unused); detection metrics live under 'monitor_values' as
    per-batch dict lists to be averaged per epoch. Missing epochs (e.g. val
    epochs that didn't run) become NaN so matplotlib gaps them.
    """
    split_d = metrics[split]
    if key in split_d:
        ys = split_d[key][1:]
    else:
        per_epoch = split_d["monitor_values"]
        ys = [
            np.mean([rec[key] for rec in per_epoch[e]]) if per_epoch[e] else np.nan
            for e in epochs
        ]
    return [np.nan if v is None else v for v in ys]


def _keys_for_figure(metrics, figure_ix, separate_values_dict):
    """Figure 0 gets every quantity not claimed by an extra figure; extra
    figures get exactly their configured key lists."""
    if figure_ix != 0:
        return list(separate_values_dict[figure_ix])
    claimed = {v for keys in separate_values_dict.values() for v in keys}
    batch_keys = [k for k in metrics["train"]["monitor_values"][1][0] if k not in claimed]
    loss_keys = [k for k in metrics["train"] if k != "monitor_values"]
    return batch_keys + loss_keys


def detection_monitoring_plot(ax1, metrics, exp_name, color_palette, epoch, figure_ix, separate_values_dict, do_validation):
    epochs = np.arange(1, epoch + 1)
    n_splits = 2 if do_validation else 1
    for kix, key in enumerate(_keys_for_figure(metrics, figure_ix, separate_values_dict)):
        color = color_palette[kix % len(color_palette)]
        for split, style in _MONITOR_SPLITS[:n_splits]:
            ax1.plot(
                epochs, _series_for_key(metrics, split, key, epochs),
                label=f"{split}_{key}", linestyle=style, color=color,
            )
    if epoch == 1:
        # one-time legend column to the right of a narrowed axis
        box = ax1.get_position()
        ax1.set_position([box.x0, box.y0, box.width * 0.8, box.height])
        ax1.legend(loc="center left", bbox_to_anchor=(1, 0.5))
        ax1.set_title(exp_name)


class TrainingPlot2Panel:
    """Per-epoch loss/metric curve figure(s), saved after every epoch. The
    figures are made at the first ``update_and_save`` (none without
    matplotlib)."""

    def __init__(self, cf):
        self.file_name = os.path.join(cf.plot_dir, f"monitor_{getattr(cf, 'fold', 0)}")
        self.exp_name = getattr(cf, "fold_dir", cf.plot_dir)
        self.do_validation = cf.do_validation
        self.separate_values_dict = cf.assign_values_to_extra_figure
        self.color_palette = _MONITOR_PALETTE
        self.n_figures = cf.n_monitoring_figures
        self.num_epochs = cf.num_epochs
        self.figure_list = None

    def _new_monitor_figure(self, plt):
        fig = plt.figure(figsize=(10, 6))
        fig.ax1 = plt.subplot(111)
        fig.ax1.set_xlabel("epochs")
        fig.ax1.set_ylabel("loss / metrics")
        fig.ax1.set_xlim(0, self.num_epochs)
        fig.ax1.grid()
        return fig

    def update_and_save(self, metrics, epoch):
        plt = _pyplot()
        if plt is None:
            return
        if self.figure_list is None:
            self.figure_list = [self._new_monitor_figure(plt) for _ in range(self.n_figures)]
            self.figure_list[0].ax1.set_ylim(0, 1.5)
        for figure_ix, fig in enumerate(self.figure_list):
            detection_monitoring_plot(
                fig.ax1, metrics, self.exp_name, self.color_palette, epoch, figure_ix,
                self.separate_values_dict, self.do_validation,
            )
            fig.savefig(self.file_name + f"_{figure_ix}")


def plot_prediction_hist(label_list, pred_list, type_list, outfile):
    """Histogram of prediction scores split by tp/fp (fn appear at score 0)."""
    plt = _pyplot()
    if plt is None:
        return
    preds = np.array(pred_list)
    labels = np.array(label_list)
    plt.figure()
    plt.yscale("log")
    # one overlay histogram per label value present
    for value, color, text in ((0, "g", "false pos."), (1, "b", "true pos. (false neg. @ score=0)")):
        if value in labels:
            plt.hist(preds[labels == value], alpha=0.3, color=color, range=(0, 1), bins=50, label=text)

    title = os.path.basename(outfile) + f" count:{len(label_list)}"
    if type_list is not None:
        counts = {t: type_list.count(t) for t in ("det_tp", "det_fp", "det_fn")}
        title += " tp:{det_tp} fp:{det_fp} fn:{det_fn} pos:{pos}".format(
            pos=counts["det_tp"] + counts["det_fn"], **counts
        )
    plt.legend()
    plt.title(title)
    plt.xlabel("confidence score")
    plt.ylabel("log n")
    plt.savefig(outfile)
    plt.close()


# curve key -> (x-axis label, legend loc) — roc/prc tuples are (xs, ys, threshs)
_STAT_CURVES = {"roc": ("1-spec.", 4), "prc": ("precision", 3)}


def _curve_present(value):
    return value is not None and not (isinstance(value, float) and np.isnan(value))


def plot_stat_curves(stats, outfile):
    plt = _pyplot()
    if plt is None:
        return
    for curve, (xlabel, legend_loc) in _STAT_CURVES.items():
        plt.figure()
        for s in stats:
            if _curve_present(s.get(curve)):
                plt.plot(s[curve][0], s[curve][1], label=f"{s['name']}_{curve}")
        plt.title(os.path.basename(outfile) + "_" + curve)
        plt.legend(loc=legend_loc)
        plt.xlabel(xlabel)
        plt.ylabel("recall")
        plt.savefig(outfile + "_" + curve)
        plt.close()
