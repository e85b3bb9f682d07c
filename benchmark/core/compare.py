"""The comparisons that decide ``correct``: what the timed path produced
against what the plain reference computes from the same inputs and weights.

Served detections (``detection_gap``). Greedy NMS is discontinuous: where
two candidates' scores nearly tie, a last-bit difference decides which of
them is kept, and everything it suppresses follows. So the reference does
not rebuild its own list and compare lists; it follows the program's
choices. For each element, in the order of the served scores, each served
detection is found among the reference's candidates (the same class, every
coordinate within one voxel, since a coordinate rounded from x.5 may move by
one, the nearest score), and its gap is the larger of how far its served
score lies from the reference's score of that candidate, and how far that
score lies below the best candidate the reference still has (not suppressed
by the detections served before it, at the threshold, in the same class).
Only candidates still unsuppressed are matched: a served detection whose
box the detections served before it suppress, or one served twice, reads 1.
Candidates the program selects but does not serve (zero area, or under
``model_min_confidence``) are taken as selected where the reference ranks
them first. Where an element is served fewer than
``model_max_instances_per_batch_element`` detections, the best candidate
still left is a detection missed, by its margin over the confidence floor.
A served detection found nowhere reads 1. A near tie thus reads as the width
of the tie, and a wrong score, box, class or a missed detection as its
error.

Served segmentation (``seg_gap``): at each voxel, how far the reference's
logit of the served class lies below its best logit.

Training (``train_gaps``): the losses of the first steps, relative, the
first step's alone (``loss1_gap``) and the worst of them (``loss_gap``): a
later step's loss may take the other side of a near tie in a
weight-dependent choice (proposals, RoI targets, hard negatives) that the
nondeterministic float32 weight gradients of the steps before it decide;
the first gradient as the optimizer takes it, per parameter tensor, as the gap
of the norms relative to the larger of the reference's norm of that tensor
and of the median tensor's; the parameters' change over the first steps,
per tensor, likewise, leaving out the tensors whose reference gradient is
below a thousandth of the median tensor's (they move by rounding alone), at
its median tensor, its 90th-percentile tensor and its worst tensor. Each
cell's workload file says which of these it holds to a limit.
"""

from __future__ import annotations

import numpy as np
import torch


def served_rows(boxes_per_image):
    """The program's results' detection dicts -> per element (coords (n, 6)
    int, class (n,), score (n,)) in descending score order."""
    out = []
    for rows in boxes_per_image:
        rows = [r for r in rows if r.get("box_type", "det") == "det"]
        rows.sort(key=lambda r: -r["box_score"])
        out.append((np.array([r["box_coords"] for r in rows], np.float64).reshape(-1, 6),
                    np.array([r["box_pred_class_id"] for r in rows], np.int64),
                    np.array([r["box_score"] for r in rows], np.float64)))
    return out


def _iou_one(box, boxes):
    """IoU with the +1-voxel convention of the program's NMS."""
    inter = np.ones(len(boxes))
    for lo, hi in ((0, 2), (1, 3), (4, 5)):
        inter *= np.clip(np.minimum(box[hi], boxes[:, hi]) - np.maximum(box[lo], boxes[:, lo]) + 1.0, 0.0, None)
    area = np.prod([box[h] - box[l] + 1.0 for l, h in ((0, 2), (1, 3), (4, 5))])
    area_all = np.prod([boxes[:, h] - boxes[:, l] + 1.0 for l, h in ((0, 2), (1, 3), (4, 5))], axis=0)
    union = area + area_all - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def detection_gap(cf, served, cand) -> float:
    """The widest gap over the served detections of a batch (module
    docstring). ``served``: ``served_rows`` of the batch; ``cand``: the
    reference's candidates as numpy arrays ``elem``, ``cls``, ``score``,
    ``box``."""
    thr, floor = cf.detection_nms_threshold, cf.model_min_confidence
    max_inst = cf.model_max_instances_per_batch_element
    worst = 0.0
    for b, (s_box, s_cls, s_score) in enumerate(served):
        sel = cand["elem"] == b
        box, cls, score = cand["box"][sel].astype(np.float64), cand["cls"][sel], cand["score"][sel].astype(np.float64)
        area = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1]) * (box[:, 5] - box[:, 4])
        unseen = (area <= 0) | (score < floor)
        left = np.ones(len(score), bool)
        taken = 0

        def take(i, with_box):
            left[i] = False
            same = left & (cls == cls[i])
            left[same] = _iou_one(with_box, box[same]) <= thr

        def take_unseen(above):
            nonlocal taken
            while taken < max_inst and left.any():
                i = int(np.flatnonzero(left)[np.argmax(score[left])])
                if not unseen[i] or score[i] < above:
                    return
                take(i, box[i])
                taken += 1

        for j in range(len(s_score)):
            if not np.isfinite(s_score[j]) or not np.isfinite(s_box[j]).all():
                return float("inf")
            near = np.flatnonzero((cls == s_cls[j]) & (np.abs(box - s_box[j]).max(axis=1) <= 1.0))
            if near.size == 0:
                worst = max(worst, 1.0)
                continue
            take_unseen(score[near[np.argmin(np.abs(score[near] - s_score[j]))]])
            near = near[left[near]]
            if near.size == 0:  # suppressed by a detection served before it, or served twice
                worst = max(worst, 1.0)
                continue
            m = near[np.argmin(np.abs(score[near] - s_score[j]))]
            visible = left & ~unseen
            best = score[visible].max() if visible.any() else score[m]
            worst = max(worst, abs(s_score[j] - score[m]), best - score[m])
            take(m, s_box[j])
            taken += 1
        take_unseen(-np.inf)
        visible = left & ~unseen
        if taken < max_inst and visible.any():
            worst = max(worst, score[visible].max() - floor)
    return float(worst)


def seg_gap(seg_preds, seg_logits) -> float:
    """The widest gap by which the reference's logit of a served class lies
    below its best logit at that voxel. seg_preds (b, 1, ...) integer
    classes (numpy), seg_logits (b, C, ...) on the device."""
    served = torch.from_numpy(np.ascontiguousarray(seg_preds)).to(seg_logits.device).long()
    picked = torch.gather(seg_logits, 1, served)
    return _worst([float((seg_logits.amax(dim=1, keepdim=True) - picked).max())])


def _norms(tensors: dict):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _norm_gaps(ours: dict, ref: dict) -> list:
    """Per tensor, the gap of the norms over the larger of the reference's
    norm of that tensor and of the median tensor's."""
    a, r = _norms(ours), _norms(ref)
    med = float(np.median(list(r.values())))
    return [abs(a[k] - r[k]) / max(r[k], med) for k in r]


def train_gaps(losses, ref_losses, grad, ref_grad, change, ref_change) -> dict:
    """The training readings (module docstring). ``grad`` / ``change``: per
    parameter name, the program's first gradient and its parameters'
    change; ``ref_*`` the reference's."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    rg = _norms(ref_grad)
    med_g = float(np.median(list(rg.values())))
    grad_gap = _worst(_norm_gaps(grad, ref_grad))
    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    change_gaps = _norm_gaps({k: change[k] for k in moved}, {k: ref_change[k] for k in moved})
    return {"loss1_gap": _worst(loss_gaps[:1]), "loss_gap": _worst(loss_gaps), "grad_gap": grad_gap,
            "change_med_gap": _median(change_gaps), "change_q90_gap": _quantile(change_gaps, 0.9),
            "change_gap": _worst(change_gaps), "left_out": len(rg) - len(moved)}


def _quantile(values, q) -> float:
    """The ``q`` quantile; infinity where any value is not a number."""
    values = np.asarray(values, np.float64)
    return float("inf") if np.isnan(values).any() else float(np.quantile(values, q))


def _median(values) -> float:
    """The median value; infinity where any is not a number."""
    values = np.asarray(values, np.float64)
    return float("inf") if np.isnan(values).any() else float(np.median(values))


def _worst(values) -> float:
    """The largest value; infinity where any is not a number."""
    values = np.asarray(values, np.float64)
    return float("inf") if np.isnan(values).any() else float(values.max())


def checks(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every reading with a limit in
    ``limits`` must not exceed it."""
    out = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in out.values()), out
