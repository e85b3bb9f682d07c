"""Host-path benchmarks of the port (no device needed): WBC consolidation,
the 2D->3D merge, evaluation and spatial augmentation, and LIDC's raw-scan
preprocessing.

The port's counterpart of the root ``tools/host_bench.py``, with the same
four benches and inputs, run through ``predictor.weighted_box_clustering``,
``predictor.nms_2to3D``, ``evaluator.Evaluator`` and
``data/augmentation.py::spatial_augment_batch``. These host stages bound
training and serving once the card is fast enough (PERF.md section 5).
Each bench runs with the native host library on and off (``MDT_NO_NATIVE``,
read per call: the Evaluator has no native path, so its two lines time the
same code). A warm-up call (which builds the native library on first use)
precedes the timed repetitions. The LIDC preprocessing bench
(``experiments/lidc_exp/preprocessing.py``: ``normalize_ct``, the
arithmetic of ``_load_normalized_ct``, and ``fuse_masks`` of one nodule of
two raters, on arrays: no file is read) has no native path: it runs once,
one repetition with no warm-up, and prints ``"native": "n/a"``.

Prints one JSON line per bench and mode, the root tool's keys plus the mode
and the host's CPU count:
  {"metric": "...", "value": N, "unit": "...", "native": "on" | "off" | "n/a", "cpus": N, ...}

    python -m medicaldetectiontoolkit_torch.tools.host_bench [--reps 3] [--wbc-boxes 4000] ...
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def _boxes(rng, n, dim, img=320):
    lo = rng.uniform(0, img - 40, (n, dim))
    ext = rng.uniform(8, 40, (n, dim))
    hi = np.minimum(lo + ext, img)
    if dim == 2:
        return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]], 1)
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1)


def _timed(fn, reps):
    """Seconds per call of ``fn`` over ``reps`` calls after one warm-up;
    returns (seconds, the last call's result)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, out


def bench_wbc(n_boxes=4000, dim=3, reps=3):
    from medicaldetectiontoolkit_torch.predictor import weighted_box_clustering

    rng = np.random.RandomState(0)
    coords = _boxes(rng, n_boxes, dim)
    dets = np.concatenate([coords, rng.uniform(0.1, 1, (n_boxes, 1)), rng.uniform(0.5, 1, (n_boxes, 1)),
                           rng.uniform(1, 4, (n_boxes, 1))], axis=1)
    pids = rng.randint(0, 20, n_boxes).astype(str)
    dt, (keep_scores, _) = _timed(lambda: weighted_box_clustering(dets, pids, 0.5, 5), reps)
    return {"metric": f"wbc_{dim}d_{n_boxes}boxes", "value": dt * 1e3, "unit": "ms", "clusters": len(keep_scores)}


def bench_nms_2to3d(n_boxes=3000, reps=3):
    from medicaldetectiontoolkit_torch.predictor import nms_2to3D

    rng = np.random.RandomState(1)
    coords = _boxes(rng, n_boxes, 2)
    dets = np.concatenate([coords, rng.uniform(0.1, 1, (n_boxes, 1)),
                           rng.randint(0, 64, (n_boxes, 1)).astype(float)], axis=1)
    dt, (keep_ix, _) = _timed(lambda: nms_2to3D(dets, 0.1), reps)
    return {"metric": f"nms_2to3d_{n_boxes}boxes", "value": dt * 1e3, "unit": "ms", "kept": len(keep_ix)}


class _Log:
    def info(self, *args, **kwargs):
        pass

    def __getattr__(self, name):
        return self.info


def bench_evaluator(n_patients=100, boxes_per=30, reps=3):
    from medicaldetectiontoolkit_torch.evaluator import Evaluator

    class _Cf:
        dim = 3
        class_dict = {1: "benign", 2: "malignant"}
        ap_match_ious = [0.1]
        report_score_level = ["patient", "rois"]
        patient_class_of_interest = 2
        min_det_thresh = 0.1
        scan_det_thresh = False
        per_patient_ap = False
        model_selection_criteria = ["benign_ap", "malignant_ap"]
        plot_prediction_histograms = False
        fold = 0
        plot_stat_curves = False
        n_cv_splits = 99  # never aggregates across folds in this bench
        test_aug = False
        test_n_epochs = 1

    rng = np.random.RandomState(2)
    results = []
    for pix in range(n_patients):
        blist = []
        for _ in range(boxes_per):
            c = _boxes(rng, 1, 3)[0]
            blist.append({"box_type": "det", "box_coords": c, "box_score": float(rng.uniform(0.1, 1)),
                          "box_pred_class_id": int(rng.randint(1, 3))})
            if rng.rand() < 0.3:
                blist.append({"box_type": "gt", "box_coords": c + rng.uniform(-3, 3, c.shape),
                              "box_label": int(rng.randint(1, 3))})
        results.append([[blist], f"p{pix}"])

    def evaluate():
        ev = Evaluator(_Cf(), _Log(), mode="test")
        ev.evaluate_predictions(results)
        ev.score_test_df()

    with tempfile.TemporaryDirectory(prefix="host_bench_") as plot_dir:
        _Cf.plot_dir = _Cf.exp_dir = plot_dir
        dt, _ = _timed(evaluate, reps)
    return {"metric": f"evaluator_{n_patients}pat_{boxes_per}box", "value": dt, "unit": "s"}


def bench_augmentation(shape=(156, 156, 96), patch=(128, 128, 64), reps=3):
    from medicaldetectiontoolkit_torch.data.augmentation import spatial_augment_batch

    rng = np.random.RandomState(3)
    data = rng.rand(1, 1, *shape).astype(np.float32)
    seg = (rng.rand(1, 1, *shape) > 0.95).astype(np.uint8)
    da_kwargs = {
        "do_elastic_deform": True, "alpha": (0.0, 1500.0), "sigma": (30.0, 50.0),
        "do_rotation": True, "angle_x": (0, 0.3), "angle_y": (0, 0), "angle_z": (0, 0),
        "do_scale": True, "scale": (0.8, 1.1), "random_crop": False,
        "order_data": 1, "border_cval_data": 0,
    }
    dt, _ = _timed(lambda: spatial_augment_batch(data, seg, tuple(patch), da_kwargs, rng), reps)
    return {"metric": "augment_3d_patch", "value": dt * 1e3, "unit": "ms"}


def bench_lidc_pp(shape=(133, 512, 512), spacing=(0.7, 0.7, 2.5)):
    """One raw chest CT of ``shape`` (z, y, x) int16 HU at ``spacing``
    (x, y, z) mm to LIDC's target spacing: the CT normalized, then one
    nodule's two rater masks (the CT's shape, uint8) resampled and fused.
    Three volume resamples, timed once each stage."""
    from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import fuse_masks, normalize_ct

    target = (0.7, 0.7, 1.25)
    rng = np.random.RandomState(4)
    ct = rng.randint(-1100, 500, size=shape).astype(np.int16)
    center = np.array(shape) // 2
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    masks = []
    for shift in (0, 1):  # a nodule of 8 mm radius, the second rater's one voxel over in x
        dist = ((zz - center[0]) * spacing[2]) ** 2 + ((yy - center[1]) * spacing[1]) ** 2 + \
            ((xx - center[2] - shift) * spacing[0]) ** 2
        masks.append(((dist < 8.0**2).astype(np.uint8), spacing))
    t0 = time.perf_counter()
    img = normalize_ct(ct, spacing, target)
    t1 = time.perf_counter()
    fused, _ = fuse_masks(masks, [3, 4], target, img.shape)
    t2 = time.perf_counter()
    return {"metric": "lidc_pp_" + "x".join(map(str, shape)), "value": t2 - t0, "unit": "s", "ct_s": t1 - t0,
            "fuse_s": t2 - t1, "shape": list(img.shape), "fused_voxels": int(fused.sum())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--wbc-boxes", type=int, default=4000)
    parser.add_argument("--nms-boxes", type=int, default=3000)
    parser.add_argument("--patients", type=int, default=100)
    parser.add_argument("--boxes-per-patient", type=int, default=30)
    parser.add_argument("--aug-shape", type=int, nargs=3, default=[156, 156, 96])
    parser.add_argument("--aug-patch", type=int, nargs=3, default=[128, 128, 64])
    parser.add_argument("--lidc-ct", type=int, nargs=3, default=[133, 512, 512], help="z y x of the raw CT")
    args = parser.parse_args(argv)
    benches = (lambda: bench_wbc(args.wbc_boxes, reps=args.reps),
               lambda: bench_nms_2to3d(args.nms_boxes, reps=args.reps),
               lambda: bench_evaluator(args.patients, args.boxes_per_patient, reps=args.reps),
               lambda: bench_augmentation(args.aug_shape, args.aug_patch, reps=args.reps))
    saved = os.environ.get("MDT_NO_NATIVE")
    lines = []
    try:
        for mode in ("on", "off"):
            os.environ["MDT_NO_NATIVE"] = "0" if mode == "on" else "1"
            for bench in benches:
                line = dict(bench(), native=mode, cpus=os.cpu_count())
                print(json.dumps(line), flush=True)
                lines.append(line)
    finally:
        if saved is None:
            os.environ.pop("MDT_NO_NATIVE", None)
        else:
            os.environ["MDT_NO_NATIVE"] = saved
    line = dict(bench_lidc_pp(tuple(args.lidc_ct)), native="n/a", cpus=os.cpu_count())
    print(json.dumps(line), flush=True)
    lines.append(line)
    return lines


if __name__ == "__main__":
    main()
