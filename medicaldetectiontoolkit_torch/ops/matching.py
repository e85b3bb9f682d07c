"""GT <-> anchor matching on the device, batched over elements (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/ops/matching.py:34-140``, which
the JAX package ``vmap``s over the batch; here the batch is a leading axis.
Same semantics:

  1. anchors whose best IoU is below ``neg_iou_threshold`` are negative (-1);
  2. every valid GT force-matches its best anchor (its class id);
  3. anchors with best IoU >= ``pos_iou_threshold`` take the class of their
     best GT;
  4. with no valid GT every anchor is negative;
  5. positives are subsampled to ``max_pos // 2`` by the lowest uniform draw
     (an exact top-k in ``lax.top_k``'s tie order), the rest set neutral;
  6. delta targets toward the best GT, normalised by ``bbox_std_dev``, zero
     off the positives.

The uniform draw is an argument, so a test can feed JAX's own draws. Where
JAX selects rows with a one-hot matmul (for the TPU's gathers) this takes a
plain gather: the one-hot product is exact, so both give the same numbers.
"""

from __future__ import annotations

import torch

from medicaldetectiontoolkit_torch.ops import boxes as box_ops
from medicaldetectiontoolkit_torch.ops.topk import top_k


def gt_anchor_matching(rand, anchors, gt_boxes, gt_class_ids, gt_valid, pos_iou_threshold, neg_iou_threshold,
                       max_pos: int, bbox_std_dev):
    """Match padded GT boxes to anchors, per batch element.

    Args:
      rand: (b, A) uniform draws in [0, 1) for the positive subsampling.
      anchors: (A, 2*dim) float32 anchors in pixel coords.
      gt_boxes: (b, G, 2*dim) float32 GT boxes, zero-padded.
      gt_class_ids: (b, G) int class ids.
      gt_valid: (b, G) bool padding mask.
      pos_iou_threshold: ``cf.anchor_matching_iou``.
      neg_iou_threshold: 0.1 in 2D, 0.01 in 3D.
      max_pos: ``cf.rpn_train_anchors_per_image``; at most ``max_pos // 2``
        positives survive.
      bbox_std_dev: (2*dim,) float32 tensor normalising the delta targets.

    Returns:
      matches (b, A) int32: class id > 0 positive, -1 negative, 0 neutral;
      delta_targets (b, A, 2*dim) float32, zero where ``matches <= 0``.
    """
    bsz, G = gt_valid.shape
    A = anchors.shape[0]
    dev = anchors.device
    gt_boxes = gt_boxes.to(torch.float32)
    gt_class_ids = gt_class_ids.to(torch.int32)

    # running best IoU over GT chunks of 8, as JAX: strict '>' keeps the
    # first maximal GT, argmax the first maximal anchor and GT within a chunk
    chunk = min(8, G)
    run_max = torch.full((bsz, A), float("-inf"), dtype=torch.float32, device=dev)
    run_arg = torch.zeros((bsz, A), dtype=torch.int64, device=dev)
    gt_best_parts = []
    for g0 in range(0, G, chunk):
        cols = box_ops.pairwise_iou(anchors, gt_boxes[:, g0:g0 + chunk])  # (b, A, c)
        cols = torch.where(gt_valid[:, None, g0:g0 + chunk], cols, -1.0)
        gt_best_parts.append(torch.argmax(cols, dim=1))  # best anchor per GT
        cmax = cols.amax(dim=2)
        carg = torch.argmax(cols, dim=2) + g0
        better = cmax > run_max
        run_max = torch.where(better, cmax, run_max)
        run_arg = torch.where(better, carg, run_arg)
    gt_best_anchor = torch.cat(gt_best_parts, dim=1)  # (b, G)
    matched_class = torch.gather(gt_class_ids, 1, run_arg)

    matches = torch.where(run_max < neg_iou_threshold, -1, 0).to(torch.int32)
    # force-match each valid GT's best anchor; invalid GTs write the spare
    # column A, which is dropped
    padded = torch.cat([matches, torch.zeros((bsz, 1), dtype=torch.int32, device=dev)], dim=1)
    scatter_ix = torch.where(gt_valid, gt_best_anchor, A)
    matches = padded.scatter(1, scatter_ix, gt_class_ids)[:, :A]
    matches = torch.where(run_max >= pos_iou_threshold, matched_class, matches)
    matches = torch.where(gt_valid.any(dim=1, keepdim=True), matches, -1)

    # random positive subsampling: keep the max_pos // 2 positives with the
    # lowest draws (an exact top-k: positives cluster in index space)
    pos = matches > 0
    k = min(max(max_pos // 2, 1), A)
    neg_vals, keep_idx = top_k(-torch.where(pos, rand, float("inf")), k, dim=1)
    keep = torch.zeros((bsz, A + 1), dtype=torch.bool, device=dev)
    keep.scatter_(1, torch.where(torch.isfinite(neg_vals), keep_idx, A), True)
    matches = torch.where(pos & ~keep[:, :A], 0, matches)

    target_gt = torch.gather(gt_boxes, 1, run_arg[..., None].expand(bsz, A, gt_boxes.shape[-1]))
    anchors = anchors.to(torch.float32).expand(bsz, A, anchors.shape[-1])
    positive = (matches > 0)[..., None]
    # degenerate padded GTs would give log(0): rows off the positives decode
    # the anchor onto itself and are zeroed anyway
    safe_gt = torch.where(positive, target_gt, anchors)
    deltas = box_ops.box_refinement(anchors, safe_gt) / bbox_std_dev
    return matches, torch.where(positive, deltas, 0.0)
