"""Mask R-CNN, 2D + 3D (torch): inference and training; base of U-Faster
R-CNN+.

Counterpart of ``medicaldetectiontoolkit_tpu/models/mrcnn.py``:
  * ``RPNHead``: shared 3x3 conv + 1x1 class (2A) / box (2*dim*A) convs per
    pyramid level, flattened in the anchor order of ``ops/anchors.py``;
  * ``ClassifierHead`` (pool_size conv -> 1x1 conv -> class logits and
    per-class box deltas) and ``MaskHead`` (4 conv3x3 -> deconv x2 -> 1x1
    conv -> sigmoid) on pooled RoIs;
  * ``pyramid_roi_align``: FPN level assignment, then the differentiable
    pyramid RoIAlign (the CUDA kernel K2 and its backward for CUDA tensors);
  * ``proposal_layer``: per-element exact top-``pre_nms_limit`` by RPN
    foreground score, decode, clip, NMS at ``rpn_nms_threshold`` padded to
    a fixed count (the NMS dispatcher: kernel K1 on the card);
  * ``refine_detections``: every proposal expanded for every foreground
    class, decode, clip, round, min-confidence filter, one NMS lane per
    (element, class), per-element top-k merge;
  * training (``mrcnn.py:343-458``, ``:586-770``): RPN matching and SHEM,
    the classify-all pass over every proposal with no gradient, then
    ``detection_target_layer`` samples RoIs by IoU and SHEM and builds their
    class, delta and mask targets, the classifier and mask heads run on the
    sampled RoIs, and the second-stage losses join the RPN's (+ dice and CE
    on the ufrcnn seg head); backward per microbatch, Adam, then detection
    refinement per microbatch.

Under spatial partitioning (``parallel/mesh.py``) ``extract`` runs on this
rank's Y slab and gathers, per level along Y, the RPN heads and the pyramid
levels that the RoI stage reads; the proposals, K1, K2 and the mask pass
then run on whole tensors, identically on every rank. In training so do the
RPN targets, ``detection_target_layer``, the heads on the sampled RoIs and
their losses; the GT masks stay on the slabs, and the rows the mask targets
read are joined by one exact sum (``mask_targets``); K2's backward writes the
gathered maps' gradients, which ``gather_y``'s backward returns to the
slabs. U-Faster R-CNN+'s seg logits, its seg labels, the seg loss's sums and
the argmax stay on the slab (``Detector._seg_space``); the argmax is joined
in the converts only where seg_preds are asked for.

As in JAX, padded and invalid proposals are not masked out: padding slots
are zero boxes, classified and refined like the rest, and the mask pass runs
on every detection slot. Tensors are channel-first; masks come out
``(b, max_inst, n_classes, *mask_shape)``. The random draws of a step come
from ``self.generator`` (``MaskRCNNDetector.draws``) and reach the loss as
tensors, so a test can feed JAX's own draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicaldetectiontoolkit_torch.models import base, register
from medicaldetectiontoolkit_torch.models.backbone import FPN, ConvND, init_weights
from medicaldetectiontoolkit_torch.ops import anchors as anchor_ops
from medicaldetectiontoolkit_torch.ops import boxes as box_ops
from medicaldetectiontoolkit_torch.ops import losses as loss_ops
from medicaldetectiontoolkit_torch.ops import matching as match_ops
from medicaldetectiontoolkit_torch.ops import nms as nms_ops
from medicaldetectiontoolkit_torch.ops import roi_align as roi_ops
from medicaldetectiontoolkit_torch.ops.losses import softmax
from medicaldetectiontoolkit_torch.ops.topk import top_k
from medicaldetectiontoolkit_torch.parallel import mesh
from medicaldetectiontoolkit_torch.utils import trace


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 class / box convs per level (``mrcnn.py:58-76``)."""

    def __init__(self, dim, cin, n_features, n_anchors_per_pos, anchor_stride=1, relu="relu",
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.conv = ConvND(dim, cin, n_features, ks=3, stride=anchor_stride, pad=1, relu=relu, dtype=dtype)
        self.logits = ConvND(dim, n_features, 2 * n_anchors_per_pos, ks=1, relu=None, dtype=dtype)
        self.deltas = ConvND(dim, n_features, 2 * dim * n_anchors_per_pos, ks=1, relu=None, dtype=dtype)

    def forward(self, x):
        x = self.conv(x)
        b = x.shape[0]
        # a Y slab's rows joined (the identity on one process), then the
        # channel-last flatten: rows in (y, x, (z), anchor) order
        logits = mesh.gather_y(self.logits(x)).movedim(1, -1).reshape(b, -1, 2)
        deltas = mesh.gather_y(self.deltas(x)).movedim(1, -1).reshape(b, -1, 2 * self.dim)
        return logits.float(), deltas.float()


class ClassifierHead(nn.Module):
    """pool_size conv -> 1x1 conv -> class logits + per-class box deltas
    (``mrcnn.py:79-106``). The two Linear layers run in float32."""

    def __init__(self, dim, end_filts, pool_size, head_classes, norm, relu, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.head_classes = head_classes
        norm = norm if norm != "instance_norm" else None  # 1x1 spatial: no instance norm
        self.conv1 = ConvND(dim, end_filts, end_filts * 4, ks=tuple(pool_size), norm=norm, relu=relu, dtype=dtype)
        self.conv2 = ConvND(dim, end_filts * 4, end_filts * 4, ks=1, norm=norm, relu=relu, dtype=dtype)
        self.cls = nn.Linear(end_filts * 4, head_classes)
        self.bbox = nn.Linear(end_filts * 4, head_classes * 2 * dim)

    def forward(self, pooled):
        # pooled: (R, C, *pool_size) float32
        x = self.conv2(self.conv1(pooled)).reshape(pooled.shape[0], -1).float()
        logits = self.cls(x)
        bbox = self.bbox(x).reshape(-1, self.head_classes, 2 * self.dim)
        return logits, bbox


class MaskHead(nn.Module):
    """4 conv3x3 -> deconv x2 -> 1x1 conv -> sigmoid per-class masks
    (``mrcnn.py:109-130``); the last conv and the sigmoid in float32."""

    def __init__(self, dim, end_filts, head_classes, norm, relu, dtype=torch.float32):
        super().__init__()
        kw = dict(norm=norm, relu=relu, dtype=dtype)
        self.convs = nn.Sequential(*[ConvND(dim, end_filts, end_filts, ks=3, pad=1, **kw) for _ in range(4)])
        deconv = nn.ConvTranspose2d if dim == 2 else nn.ConvTranspose3d
        self.deconv = deconv(end_filts, end_filts, 2, stride=2)
        self.final = ConvND(dim, end_filts, head_classes, ks=1, relu=None, dtype=torch.float32)
        self.relu = relu
        self.dtype = dtype

    def forward(self, pooled):
        x = self.convs(pooled)
        d = self.deconv
        up = F.conv_transpose2d if isinstance(d, nn.ConvTranspose2d) else F.conv_transpose3d
        x = up(x.to(self.dtype), d.weight.to(self.dtype), d.bias.to(self.dtype), stride=2)
        x = F.relu(x) if self.relu == "relu" else F.leaky_relu(x, 0.01)
        return torch.sigmoid(self.final(x).float())  # (R, n_classes, *mask_shape)


class MRCNNModule(nn.Module):
    """FPN + RPN + classifier / mask heads (+ the ufrcnn P0 seg head), with
    the stages as separate methods (``mrcnn.py:133-212``)."""

    def __init__(self, dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                 operate_stride1, head_classes, n_rpn_features, n_anchors_per_pos, anchor_stride,
                 pyramid_levels: Sequence[int], pool_size, mask_pool_size, with_mask_head=True,
                 num_seg_classes=0, dtype=torch.float32, remat=False):
        super().__init__()
        self.dtype = dtype
        self.operate_stride1 = operate_stride1
        self.pyramid_levels = tuple(pyramid_levels)
        self.pool_size = tuple(pool_size)
        self.mask_pool_size = tuple(mask_pool_size)
        self.fpn = FPN(dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                       operate_stride1, dtype=dtype, remat=remat)
        self.rpn = RPNHead(dim, end_filts, n_rpn_features, n_anchors_per_pos, anchor_stride, relu, dtype=dtype)
        self.classifier = ClassifierHead(dim, end_filts, pool_size, head_classes, norm, relu, dtype=dtype)
        self.mask = MaskHead(dim, end_filts, head_classes, norm, relu, dtype=dtype) if with_mask_head else None
        # the seg head runs in float32 whatever the compute dtype
        self.final_conv = (
            ConvND(dim, end_filts, num_seg_classes, ks=1, relu=None, dtype=torch.float32)
            if num_seg_classes else None
        )

    def extract(self, img):
        """img -> (feature maps, rpn_logits (b, A, 2), rpn_deltas (b, A, 2d),
        seg_logits): under spatial partitioning the maps and the RPN heads
        gathered along Y, the seg logits this rank's slab."""
        fpn_outs = self.fpn(img.to(self.dtype))
        slabs = self.fpn.slab_levels
        seg_logits = None
        if self.final_conv is not None:
            with mesh.on_slabs(slabs[0]):
                seg_logits = self.final_conv(fpn_outs[0])
        offset = 1 if self.operate_stride1 else 0
        maps, outs = [], []
        for i in self.pyramid_levels:
            with mesh.on_slabs(slabs[i + offset]):
                outs.append(self.rpn(fpn_outs[i + offset]))
                maps.append(mesh.gather_y(fpn_outs[i + offset]))
        rpn_logits = torch.cat([o[0] for o in outs], dim=1)
        rpn_deltas = torch.cat([o[1] for o in outs], dim=1)
        return maps, rpn_logits, rpn_deltas, seg_logits

    def classify_rois(self, feature_maps, boxes_norm, batch_ix, align_fn=roi_ops.pyramid_roi_align_auto):
        return self.classifier(pyramid_roi_align(feature_maps, boxes_norm, batch_ix, self.pool_size,
                                                 self.pyramid_levels, align_fn))

    def mask_rois(self, feature_maps, boxes_norm, batch_ix, align_fn=roi_ops.pyramid_roi_align_auto):
        return self.mask(pyramid_roi_align(feature_maps, boxes_norm, batch_ix, self.mask_pool_size,
                                           self.pyramid_levels, align_fn))


def roi_levels(boxes_norm, pyramid_levels):
    """FPN level index of each RoI (``mrcnn.py:232-239``): clamp(round(4 +
    log2(sqrt(h*w))), first, last) in float32, half to even as
    ``jnp.round``; with a 5th level, RoIs with h*w > 0.65 go to P6. Returns
    (R,) int32 indices into ``pyramid_levels``."""
    h = boxes_norm[:, 2] - boxes_norm[:, 0]
    w = boxes_norm[:, 3] - boxes_norm[:, 1]
    hw = torch.clamp_min(h * w, 1e-12)
    with trace.span("wait", what="log(2) to the card"):  # a pageable copy: the host waits for the queued work
        log2 = torch.tensor(math.log(2.0), dtype=torch.float32, device=boxes_norm.device)
    level = torch.round(4.0 + torch.log(torch.sqrt(hw)) / log2).to(torch.int32)
    level = torch.clamp(level, pyramid_levels[0], pyramid_levels[-1])
    if len(pyramid_levels) == 5:
        level = torch.where(hw > 0.65, 5, level)
    return level - pyramid_levels[0]


def pyramid_roi_align(feature_maps, boxes_norm, batch_ix, pool_size, pyramid_levels,
                      align_fn=roi_ops.pyramid_roi_align_auto):
    """FPN-level-assigned RoIAlign (``mrcnn.py:220-242``); ``align_fn``
    defaults to the device-keyed dispatcher. Returns (R, C, *pool_size)
    float32."""
    levels_idx = roi_levels(boxes_norm, pyramid_levels)
    return align_fn(list(feature_maps), boxes_norm, batch_ix, levels_idx, tuple(pool_size))


def proposal_layer(rpn_probs_fg, rpn_deltas, anchors, cf, proposal_count: int, nms_fn=nms_ops.batched_nms_auto):
    """RPN proposals: exact top-k -> decode -> clip -> NMS -> pad to a fixed
    count (``mrcnn.py:245-278``).

    rpn_probs_fg (b, A), rpn_deltas (b, A, 2d), anchors (A, 2d) pixel coords.
    Returns (normalised boxes (b, P, 2d), out_proposals (b, P, 2d + 1) with
    the fg scores, valid (b, P)); padded slots are zero boxes.
    """
    dev = rpn_probs_fg.device
    std = base.host_to_device(np.asarray(cf.rpn_bbox_std_dev), dev)
    window = base.host_to_device(np.asarray(cf.window), dev)
    norm = base.host_to_device(np.asarray(cf.scale), dev)
    k = min(cf.pre_nms_limit, anchors.shape[0])

    top_scores, order = top_k(rpn_probs_fg, k, dim=1)  # (b, k), lax.top_k's tie order
    deltas = torch.take_along_dim(rpn_deltas, order[..., None], dim=1) * std
    boxes = box_ops.clip_boxes(box_ops.apply_box_deltas(anchors[order], deltas), window)
    trace.count("k1.lanes", boxes.shape[0])
    trace.count("k1.candidates", boxes.shape[0] * k)
    keep_idx, keep_mask = nms_fn(boxes, top_scores, cf.rpn_nms_threshold, proposal_count)

    safe = keep_idx.long().clamp(0, k - 1)
    out_boxes = torch.where(keep_mask[..., None], torch.take_along_dim(boxes, safe[..., None], dim=1), 0.0)
    out_scores = torch.where(keep_mask, torch.take_along_dim(top_scores, safe, dim=1), 0.0)
    return out_boxes / norm, torch.cat([out_boxes, out_scores[..., None]], dim=-1), keep_mask


def refine_detections(rois_norm, probs, deltas, batch_ix, cf, batch_size: int, nms_fn=nms_ops.batched_nms_auto):
    """Second-stage detection refinement (``mrcnn.py:281-340``).

    rois_norm (R, 2d) normalised proposals (R = b * P); probs (R, C); deltas
    (R, C, 2d); batch_ix (R,). Returns (detections (b, max_inst, 2d + 2)
    = [coords, class, score], mask (b, max_inst)).
    """
    dim = cf.dim
    R, C = probs.shape
    n_fg = C - 1
    dev = probs.device
    max_inst = cf.model_max_instances_per_batch_element
    std = base.host_to_device(np.asarray(cf.rpn_bbox_std_dev), dev)
    scale = base.host_to_device(np.asarray(cf.scale), dev)
    window = base.host_to_device(np.asarray(cf.window), dev)

    # (R * n_fg) candidates, class-major per RoI
    cls_range = torch.arange(1, C, device=dev)
    cand_scores = probs[:, 1:].reshape(-1)
    cand_class = cls_range.repeat(R)
    cand_batch = batch_ix.repeat_interleave(n_fg)
    deltas_specific = deltas[:, 1:, :].reshape(-1, 2 * dim)
    rois_rep = rois_norm.repeat_interleave(n_fg, dim=0)
    boxes = box_ops.apply_box_deltas(rois_rep, deltas_specific * std) * scale
    boxes = torch.round(box_ops.clip_boxes(boxes, window))  # half-to-even, as jnp.round
    conf_ok = cand_scores >= cf.model_min_confidence

    # one NMS lane per (element, class) over one broadcast candidate array
    n_lanes = batch_size * n_fg
    lane_elem = torch.arange(batch_size, device=dev).repeat_interleave(n_fg)
    lane_class = cls_range.repeat(batch_size)
    lane_valid = conf_ok[None, :] & (cand_batch[None, :] == lane_elem[:, None]) & (
        cand_class[None, :] == lane_class[:, None])
    n = cand_scores.shape[0]
    trace.count("k1.lanes", n_lanes)
    trace.count("k1.candidates", n_lanes * n)
    lane_idx, lane_mask = nms_fn(
        boxes.expand(n_lanes, n, 2 * dim), cand_scores.expand(n_lanes, n),
        cf.detection_nms_threshold, max_inst, valid=lane_valid,
    )
    lane_idx = lane_idx.reshape(batch_size, n_fg * max_inst).long()
    lane_mask = lane_mask.reshape(batch_size, n_fg * max_inst)

    merged_scores = torch.where(lane_mask, cand_scores[lane_idx.clamp(0, n - 1)], float("-inf"))
    _, top_pos = top_k(merged_scores, max_inst, dim=1)
    final_idx = torch.take_along_dim(lane_idx, top_pos, dim=1).clamp(0, n - 1)
    final_mask = torch.take_along_dim(lane_mask, top_pos, dim=1)

    det = torch.cat(
        [boxes[final_idx], cand_class[final_idx][..., None].to(torch.float32), cand_scores[final_idx][..., None]],
        dim=-1,
    )
    return det, final_mask


def masked_topk_indices(key, k: int):
    """Indices of the ``k`` smallest keys along the last axis, ties to the
    lower index, and whether each is valid (key < +inf) (``mrcnn.py:343-346``)."""
    neg_vals, idx = top_k(-key, k)
    return idx, torch.isfinite(neg_vals)


def roi_slots(cf):
    """(positive, negative) RoI slots per element (``mrcnn.py:366-368``)."""
    n_pos = max(1, int(cf.train_rois_per_image * cf.roi_positive_ratio))
    return n_pos, max(1, int(n_pos * (1.0 / cf.roi_positive_ratio - 1.0)))


def mask_targets(gt_masks, assignment, rois, keep, mask_shape, space=None):
    """The mask targets of the positive slots: each slot's assigned GT mask
    cropped at its RoI by the plain ``roi_align`` (``mask_shape``), rounded,
    and 0 where ``keep`` is false (``mrcnn.py:403-411``).

    gt_masks (b, M, Y, ...) uint8, or under spatial partitioning this rank's
    Y slab of them, ``space`` its SpaceGroup; assignment (b, S_pos) mask
    slot; rois (b, S_pos, 2d) normalised; keep (b, S_pos). The two rows each
    crop row reads are indexed in the whole image and gathered as uint8, on
    a slab where this rank owns them and zeros elsewhere, then joined by one
    ``space.sum`` (kind ``mask_rows``) of a fixed shape, every slot valid or
    not: each row has one owner, so the sum is exact and the lerps
    (``roi_ops.roi_lerp``) run on the rows one process gathers. Returns (b,
    S_pos, *mask_shape) float32."""
    bsz, n_slots = assignment.shape
    n_rows, rest = gt_masks.shape[2], tuple(gt_masks.shape[3:])
    dim, ch = len(mask_shape), mask_shape[0]
    axes = roi_ops.roi_axes(rois.reshape(-1, 2 * dim), mask_shape,
                            (n_rows * (1 if space is None else space.size), *rest))
    ys = torch.stack(axes[0][:2]).long().reshape(2, bsz, n_slots, ch)  # whole-image rows
    local = ys if space is None else ys - space.rank * n_rows
    b_ix = torch.arange(bsz, device=ys.device)[:, None, None]
    rows = gt_masks[b_ix, assignment[..., None], local.clamp(0, n_rows - 1)]  # (2, b, S_pos, ch, W, (Z))
    if space is not None:
        own = ((local >= 0) & (local < n_rows)).reshape(ys.shape + (1,) * len(rest))
        rows = space.sum(torch.where(own, rows, torch.zeros((), dtype=rows.dtype, device=rows.device)),
                         "mask_rows")
    rows = rows.to(torch.float32).reshape(2, bsz * n_slots, ch, *rest, 1)
    crops = roi_ops.roi_lerp(rows[0], rows[1], axes, mask_shape)[:, 0].reshape(bsz, n_slots, *mask_shape)
    return torch.round(torch.where(keep.reshape(bsz, n_slots, *(1,) * dim), crops, 0.0))


def detection_target_layer(draws, proposals_norm, prop_valid, class_scores, gt_boxes_norm, gt_ids, gt_valid,
                           gt_masks, cf, space=None):
    """Sample RoIs and build the second-stage targets, batched over elements
    (``mrcnn.py:349-428``, which JAX ``vmap``s).

    draws: (pos_rand (b, P), shem_rand (b, k_pool), neg_rand (b, P)) uniform
    draws: positive sampling, SHEM's pool draw, negative sampling (JAX draws
    the last two from one key). proposals_norm (b, P, 2d), prop_valid (b, P),
    class_scores (b, P, C), gt_boxes_norm (b, G, 2d), gt_ids (b, G), gt_valid
    (b, G), gt_masks (b, M, *spatial) uint8 with M <= G mask slots, this
    rank's Y slab of them under spatial partitioning (``space``, the
    SpaceGroup: the layer runs after the forward, where ``mesh.space()`` is
    None), or None without a mask head.

    Returns per element S = n_pos + n_neg slots: rois (b, S, 2d), slot_valid,
    target_class (int32), target_deltas (b, S, 2d), target_masks (b, S,
    *mask_shape), pos_mask, and mask_pos: pos_mask restricted to positives
    whose GT has a mask slot. Mask targets are the assigned GT masks cropped
    by the plain ``roi_align`` at ``cf.mask_shape``, rounded
    (``mask_targets``); target_masks and mask_pos are None when gt_masks is.
    """
    pos_rand, shem_rand, neg_rand = draws
    dim = cf.dim
    bsz = proposals_norm.shape[0]
    dev = proposals_norm.device
    n_pos_slots, n_neg_slots = roi_slots(cf)
    r = 1.0 / cf.roi_positive_ratio
    pos_iou = 0.5 if dim == 2 else 0.3
    neg_iou = 0.1 if dim == 2 else 0.01
    any_gt = gt_valid.any(dim=1, keepdim=True)

    overlaps = box_ops.pairwise_iou(proposals_norm, gt_boxes_norm)  # (b, P, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)
    roi_iou_max = overlaps.amax(dim=2)
    pos_bool = (roi_iou_max >= pos_iou) & any_gt
    neg_bool = torch.where(any_gt, roi_iou_max < neg_iou, True)

    # positives: the lowest uniform draws among them
    pos_idx, pos_valid = masked_topk_indices(torch.where(pos_bool, pos_rand, float("inf")), n_pos_slots)
    n_pos = pos_valid.sum(dim=1)
    pos_ov = torch.take_along_dim(overlaps, pos_idx[..., None], dim=1)
    assignment = torch.argmax(pos_ov, dim=2)  # first maximum, as jnp.argmax
    pos_rois = torch.take_along_dim(proposals_norm, pos_idx[..., None], dim=1)
    roi_gt_boxes = torch.take_along_dim(gt_boxes_norm, assignment[..., None], dim=1)
    safe_gt = torch.where(pos_valid[..., None], roi_gt_boxes, pos_rois + 1e-3)
    with trace.span("wait", what="eps to the card"):  # a pageable copy: the host waits for the queued work
        eps = torch.tensor([0.0, 0.0, 1e-3, 1e-3] + ([0.0, 1e-3] if dim == 3 else []), dtype=torch.float32,
                           device=dev)
    safe_rois = torch.where((box_ops.box_area(pos_rois) > 0)[..., None], pos_rois, pos_rois + eps)
    std = base.host_to_device(np.asarray(cf.bbox_std_dev), dev)
    deltas = torch.where(pos_valid[..., None], box_ops.box_refinement(safe_rois, safe_gt) / std, 0.0)
    target_class_pos = torch.where(pos_valid, torch.gather(gt_ids.to(torch.int32), 1, assignment), 0)

    # mask targets: a positive assigned past the mask slots gets no mask
    # supervision
    target_masks = mask_pos_valid = None
    if gt_masks is not None:
        n_masks = gt_masks.shape[1]
        mask_pos_valid = pos_valid & (assignment < n_masks)
        target_masks = mask_targets(gt_masks, assignment.clamp(0, n_masks - 1), pos_rois, mask_pos_valid,
                                    tuple(cf.mask_shape), space)

    # negatives: SHEM on the predicted fg scores, then the lowest draws
    fg_scores = class_scores[..., 1:].amax(dim=-1)
    neg_count = torch.round(n_pos.to(torch.float32) * (r - 1.0)).to(torch.int64).clamp_min(1)
    sel = loss_ops.shem_select(shem_rand, fg_scores, neg_bool & prop_valid, neg_count, n_neg_slots, cf.shem_poolsize)
    neg_idx, neg_valid = masked_topk_indices(torch.where(sel, neg_rand, float("inf")), n_neg_slots)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((bsz, n_neg_slots, *shape), dtype=dtype, device=dev)

    rois = torch.cat([pos_rois, torch.take_along_dim(proposals_norm, neg_idx[..., None], dim=1)], dim=1)
    slot_valid = torch.cat([pos_valid, neg_valid], dim=1)
    target_class = torch.cat([target_class_pos, zeros(dtype=torch.int32)], dim=1)
    target_deltas = torch.cat([deltas, zeros(2 * dim)], dim=1)
    pos_mask = torch.cat([pos_valid, zeros(dtype=torch.bool)], dim=1)
    mask_pos = None
    if gt_masks is not None:
        target_masks = torch.cat([target_masks, zeros(*cf.mask_shape)], dim=1)
        mask_pos = torch.cat([mask_pos_valid, zeros(dtype=torch.bool)], dim=1)
    return rois, slot_valid, target_class, target_deltas, target_masks, pos_mask, mask_pos


def _flat_mean(values, mask):
    """``masked_mean`` over all of ``values``, as JAX's over one flat batch
    (the global batch in a data-parallel step: ``mesh.batch_sum``)."""
    mask = mask.to(values.dtype)
    total, count = mesh.batch_sum(torch.stack([(values * mask).sum(), mask.sum()]))
    return torch.where(count > 0, total / count.clamp_min(1.0), 0.0)


def mrcnn_class_loss(target_class, logits, slot_valid):
    """CE of the sampled RoIs' classes over the valid slots (``mrcnn.py:431-433``)."""
    return _flat_mean(loss_ops.softmax_ce(logits, target_class.clamp_min(0)), slot_valid)


def mrcnn_bbox_loss(target_deltas, pred_deltas, target_class, pos_mask):
    """Smooth-L1 of the target class's deltas over the positives
    (``mrcnn.py:436-440``): pred_deltas (S, C, 2d)."""
    cls = target_class.clamp(0, pred_deltas.shape[1] - 1).long()
    per = loss_ops.smooth_l1(pred_deltas[torch.arange(cls.shape[0], device=cls.device), cls], target_deltas)
    return _flat_mean(per, pos_mask[:, None].expand_as(per))


def mrcnn_mask_loss(target_masks, pred_masks, target_class, pos_mask):
    """BCE of the target class's mask over the positives
    (``mrcnn.py:443-452``): pred_masks (S, C, *mask_shape) probabilities."""
    cls = target_class.clamp(0, pred_masks.shape[1] - 1).long()
    sel = pred_masks[torch.arange(cls.shape[0], device=cls.device), cls]
    eps = 1e-7
    bce = -(target_masks * torch.log(sel.clamp(eps, 1.0)) + (1 - target_masks) * torch.log((1 - sel).clamp(eps, 1.0)))
    return _flat_mean(bce, pos_mask.reshape((-1,) + (1,) * (bce.dim() - 1)).expand_as(bce))


@register("mrcnn")
class MaskRCNNDetector(base.Detector):
    """Host-facing Mask R-CNN with the reference's test_forward API."""

    with_mask_head = True
    with_seg_head = False  # ufrcnn overrides
    # the two kernels' entry points: the device-keyed dispatchers; a check
    # swaps in the plain versions to compare on the same heads
    nms_fn = staticmethod(nms_ops.batched_nms_auto)
    align_fn = staticmethod(roi_ops.pyramid_roi_align_auto)

    def build(self):
        cf = self.cf
        h, w = cf.patch_size[:2]
        if h % 2**5 or w % 2**5:
            raise ValueError("patch size must be divisible by 2**5")
        if len(cf.patch_size) == 3 and cf.patch_size[2] % 2**3:
            raise ValueError("patch z dimension must be divisible by 2**3")
        self.anchors = anchor_ops.generate_pyramid_anchors(cf, self.logger).to(self.device, torch.float32)
        self.module = MRCNNModule(
            dim=cf.dim,
            n_channels=cf.n_channels,
            start_filts=cf.start_filts,
            end_filts=cf.end_filts,
            res_architecture=cf.res_architecture,
            norm=cf.norm,
            relu=cf.relu,
            sixth_pooling=cf.sixth_pooling,
            operate_stride1=cf.operate_stride1,
            head_classes=cf.head_classes,
            n_rpn_features=cf.n_rpn_features,
            n_anchors_per_pos=len(cf.rpn_anchor_ratios),
            anchor_stride=cf.rpn_anchor_stride,
            pyramid_levels=cf.pyramid_levels,
            pool_size=cf.pool_size,
            mask_pool_size=cf.mask_pool_size,
            with_mask_head=self.with_mask_head and not cf.frcnn_mode,
            num_seg_classes=cf.num_seg_classes if self.with_seg_head else 0,
            dtype=torch.bfloat16 if cf.compute_dtype == "bfloat16" else torch.float32,
            remat=base.resolve_remat(cf),
        ).to(self.device).eval()
        self.np_anchors = self.anchors.cpu().numpy()
        self.rpn_std = base.host_to_device(np.asarray(cf.rpn_bbox_std_dev), self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cf.seed)

    def init_params(self, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        init_weights(self.module, self.cf.weight_init, gen)
        # the classifier's first conv is a bare flax nn.Conv: flax's default
        # init (lecun_normal) whatever cf.weight_init says (mrcnn.py:95-97)
        init_weights(self.module.classifier.conv1.conv, None, gen)

    # ---- forward -----------------------------------------------------------
    def _proposals(self, rpn_logits, rpn_deltas, count=None):
        """(normalised proposals (b, P, 2d), out_proposals, valid) of the
        RPN heads (``mrcnn.py:526-534``); P is ``count``, by default
        ``post_nms_rois_inference``. No gradient flows through them."""
        with trace.span("proposals", device=self.device):
            rpn_probs_fg = softmax(rpn_logits.detach())[..., 1]
            return proposal_layer(rpn_probs_fg, rpn_deltas.detach(), self.anchors, self.cf,
                                  count or self.cf.post_nms_rois_inference, nms_fn=self.nms_fn)

    def _second_stage_all(self, maps, rois_norm):
        """Classify every proposal in chunks of ``cf.roi_chunk_size`` RoIs
        (``mrcnn.py:536-567``): R is padded with zero boxes on element 0 to
        a multiple of the chunk, so every chunk has one shape."""
        bsz, P = rois_norm.shape[:2]
        flat_rois = rois_norm.reshape(-1, rois_norm.shape[-1])
        batch_ix = torch.arange(bsz, dtype=torch.int32, device=rois_norm.device).repeat_interleave(P)
        chunk = getattr(self.cf, "roi_chunk_size", None)
        R = flat_rois.shape[0]
        with trace.span("classify_all", device=self.device):
            if chunk and R > chunk:
                pad = (-R) % chunk
                trace.count("k2.slots", R + pad)
                rois_c = F.pad(flat_rois, (0, 0, 0, pad))
                bix_c = F.pad(batch_ix, (0, pad))
                outs = [self.module.classify_rois(maps, rois_c[i:i + chunk], bix_c[i:i + chunk], self.align_fn)
                        for i in range(0, R + pad, chunk)]
                logits = torch.cat([o[0] for o in outs])[:R]
                bbox = torch.cat([o[1] for o in outs])[:R]
            else:
                trace.count("k2.slots", R)
                logits, bbox = self.module.classify_rois(maps, flat_rois, batch_ix, self.align_fn)
        return logits, bbox, flat_rois, batch_ix

    def _detections_and_masks(self, maps, flat_rois, batch_ix, logits, bbox, bsz, with_masks: bool):
        cf = self.cf
        with trace.span("refine", device=self.device):
            det, det_mask = refine_detections(flat_rois, softmax(logits), bbox, batch_ix, cf, bsz, nms_fn=self.nms_fn)
        det_masks_raw = self._masks(maps, det) if with_masks and self.module.mask is not None else None
        return det, det_mask, det_masks_raw

    def _masks(self, maps, det):
        """Mask head on every detection slot, valid or not (``mrcnn.py:574-583``):
        (b, max_inst, n_classes, *mask_shape)."""
        cf = self.cf
        bsz, max_inst = det.shape[:2]
        scale = base.host_to_device(np.asarray(cf.scale), det.device)
        det_boxes_norm = det[..., : 2 * cf.dim].reshape(-1, 2 * cf.dim) / scale
        det_bix = torch.arange(bsz, dtype=torch.int32, device=det.device).repeat_interleave(max_inst)
        m = self.module.mask_rois(maps, det_boxes_norm, det_bix, self.align_fn)
        return m.reshape((bsz, max_inst) + tuple(m.shape[1:]))

    def _forward(self, img, with_masks: bool):
        """img (b, c, *spatial) -> (det, det_mask, det_masks_raw | None,
        seg_preds | None) on the device (``_predict``, ``mrcnn.py:772-782``)."""
        return self._from_heads(self._spatial(self.module.extract, img), img.shape[0], with_masks)

    def _from_heads(self, heads, bsz: int, with_masks: bool):
        """The stages after the FPN and RPN: proposals, classify-all,
        refinement, masks, seg argmax."""
        maps, rpn_logits, rpn_deltas, seg_logits = heads
        rois_norm, _, _ = self._proposals(rpn_logits, rpn_deltas)
        logits, bbox, flat_rois, batch_ix = self._second_stage_all(maps, rois_norm)
        det, det_mask, det_masks_raw = self._detections_and_masks(
            maps, flat_rois, batch_ix, logits, bbox, bsz, with_masks)
        seg_preds = None
        if seg_logits is not None:
            seg_preds = torch.argmax(seg_logits, dim=1, keepdim=True).to(torch.uint8)
        return det, det_mask, det_masks_raw, seg_preds

    def _make_seg_preds(self, det, det_mask, det_masks_raw, seg_preds, data_shape, with_masks: bool):
        """Host seg output (``mrcnn.py:860-888``): ufrcnn's argmaxed seg head,
        else the union of the unmolded instance masks (uint8), or a float32
        zero volume when no masks were asked for."""
        cf = self.cf
        if seg_preds is not None:
            seg_preds = self._seg_whole(seg_preds, data_shape[2])
            with trace.span("wait", what="seg_preds"):
                return seg_preds.cpu().numpy()
        spatial = tuple(data_shape[2:])
        seg = np.zeros((data_shape[0], 1) + spatial, dtype=np.uint8)
        if det_masks_raw is None:
            return seg.astype(np.float32) if not with_masks else seg
        with trace.span("wait", what="masks"):
            det, det_mask = det.cpu().numpy(), det_mask.cpu().numpy()
            masks = det_masks_raw.cpu().numpy()  # (b, max_inst, n_classes, *mask_shape)
        ncoords = 2 * cf.dim
        for b in range(det.shape[0]):
            full = np.zeros(spatial, dtype=np.float32)
            for i in np.flatnonzero(det_mask[b]):
                coords = det[b, i, :ncoords].astype(np.int32)
                cls = int(det[b, i, ncoords])
                if cls <= 0:
                    continue
                sizes = [coords[2] - coords[0], coords[3] - coords[1]] + (
                    [coords[5] - coords[4]] if cf.dim == 3 else [])
                if any(s <= 0 for s in sizes):
                    continue
                full = np.maximum(full, base.unmold_mask(masks[b, i, cls], coords, spatial))
            seg[b, 0] = np.round(full).astype(np.uint8)
        return seg


    # ---- training ---------------------------------------------------------
    def _prep(self, batch):
        """Upload one batch (``mrcnn.py:790-819``): image, padded GTs, the
        GT masks as uint8 (b, max_gt_masks, *spatial) with the first
        ``max_gt_masks`` of each element's masks, and (ufrcnn) seg labels.
        Under spatial partitioning the masks are this rank's Y slab, cut on
        the host before the copy, as the seg labels are where the seg path
        runs on slabs. Without a mask head (U-Faster R-CNN+, ``frcnn_mode``)
        no masks go up: nothing reads them (JAX's are dropped as unused)."""
        cf, dev = self.cf, self.device
        img = base.host_to_device(batch["data"], dev)
        bsz, spatial = img.shape[0], tuple(img.shape[2:])
        gt = base.pad_gt_boxes(batch["bb_target"], batch["roi_labels"], bsz, cf.dim, cf.max_gt_boxes, dev)
        gt_masks = None
        if self.module.mask is not None:
            max_gt_masks = min(cf.max_gt_boxes, getattr(cf, "max_gt_masks", None) or cf.max_gt_boxes)
            ys = slice(None) if self.space is None else self.space.rows(spatial[0])
            n_rows = spatial[0] if self.space is None else spatial[0] // self.space.size
            gt_masks = np.zeros((bsz, max_gt_masks, n_rows) + spatial[1:], dtype=np.uint8)
            for b, rm in enumerate(batch.get("roi_masks", ())):
                rm = np.asarray(rm)
                if rm.ndim == len(spatial) + 2:  # (n_rois, 1, *spatial)
                    rm = rm[:, 0]
                n = min(rm.shape[0], max_gt_masks)
                if n and rm.shape[1:] == spatial:
                    gt_masks[b, :n] = rm[:n, ys]
            gt_masks = base.host_to_device(gt_masks, dev, np.uint8)
        seg = None
        if self.with_seg_head:
            labels = batch["seg"] if "seg" in batch else np.zeros((bsz, 1, *spatial), np.int32)
            seg = base.host_to_device(self._seg_slab(labels), dev, np.int32)
        return (img, *gt, gt_masks, seg)

    def draws(self, n_micro: int, m: int):
        """One step's uniform draws from ``self.generator``, per microbatch of
        ``m`` elements: RPN matching (n_micro, m, A), RPN SHEM (.., k_pool),
        RoI positives (.., P), RoI SHEM (.., k_pool') and RoI negatives
        (.., P), P = ``post_nms_rois_training``."""
        cf = self.cf
        A = self.anchors.shape[0]
        P = cf.post_nms_rois_training
        sizes = (A, min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A), P,
                 min(cf.shem_poolsize * roi_slots(cf)[1], P), P)
        return tuple(torch.rand((n_micro, m, n), generator=self.generator, device=self.device) for n in sizes)

    def _losses(self, inputs, draws, with_masks: bool = False):
        """Loss and aux of one microbatch (``mrcnn.py:586-676``); ``draws``
        are ``self.draws``' five tensors of one microbatch. With
        ``with_masks`` the aux keeps the maps for the mask pass."""
        cf = self.cf
        img, gt_boxes, gt_ids, gt_valid, gt_masks, seg = inputs
        match_rand, rpn_shem_rand, pos_rand, roi_shem_rand, neg_rand = draws
        bsz, dev = img.shape[0], img.device
        neg_iou = 0.1 if cf.dim == 2 else 0.01
        scale = base.host_to_device(np.asarray(cf.scale), dev)

        maps, rpn_logits, rpn_deltas, seg_logits = self._spatial_train(self.module.extract, img)
        rois_norm, out_proposals, prop_valid = self._proposals(rpn_logits, rpn_deltas, cf.post_nms_rois_training)
        with torch.no_grad():
            cls_logits_all, bbox_all, flat_rois, batch_ix = self._second_stage_all(maps, rois_norm)
        with trace.span("losses", device=self.device):
            # RPN losses on binary fg labels
            rpn_match, rpn_tdeltas = match_ops.gt_anchor_matching(
                match_rand, self.anchors, gt_boxes, torch.ones_like(gt_ids), gt_valid, cf.anchor_matching_iou,
                neg_iou, cf.rpn_train_anchors_per_image, self.rpn_std)
            rpn_class_losses, neg_sel = loss_ops.anchor_class_loss(
                rpn_shem_rand, rpn_match, rpn_logits, cf.shem_poolsize, cf.rpn_train_anchors_per_image // 2)
            rpn_class_loss = mesh.batch_mean(rpn_class_losses)
            rpn_bbox_loss = mesh.batch_mean(loss_ops.anchor_bbox_loss(rpn_tdeltas, rpn_deltas, rpn_match))

            # detection targets, then the heads on the sampled RoIs
            probs_pe = softmax(cls_logits_all).reshape(bsz, -1, cls_logits_all.shape[-1])
            with trace.span("targets", device=self.device):
                s_rois, s_valid, s_class, s_deltas, s_masks, s_pos, s_mask_pos = detection_target_layer(
                    (pos_rand, roi_shem_rand, neg_rand), rois_norm, prop_valid, probs_pe, gt_boxes / scale, gt_ids,
                    gt_valid, gt_masks, cf, space=self.space)
            S = s_rois.shape[1]
            flat_s_rois = s_rois.reshape(-1, 2 * cf.dim)
            s_bix = torch.arange(bsz, dtype=torch.int32, device=dev).repeat_interleave(S)
            s_logits, s_bbox = self.module.classify_rois(maps, flat_s_rois, s_bix, self.align_fn)
            flat_class, flat_pos = s_class.reshape(-1), s_pos.reshape(-1)
            cls_loss = mrcnn_class_loss(flat_class, s_logits, s_valid.reshape(-1))
            bbox_loss = mrcnn_bbox_loss(s_deltas.reshape(-1, 2 * cf.dim), s_bbox, flat_class, flat_pos)
            mask_loss = torch.zeros((), device=dev)
            if self.module.mask is not None:
                s_pred_masks = self.module.mask_rois(maps, flat_s_rois, s_bix, self.align_fn)
                mask_loss = mrcnn_mask_loss(s_masks.reshape(-1, *cf.mask_shape), s_pred_masks, flat_class,
                                            s_mask_pos.reshape(-1))

            loss = rpn_class_loss + rpn_bbox_loss + cls_loss + bbox_loss + mask_loss
            monitor = {"loss": loss, "class_loss": cls_loss, "rpn_class_loss": rpn_class_loss,
                       "rpn_bbox_loss": rpn_bbox_loss, "mrcnn_bbox_loss": bbox_loss, "mrcnn_mask_loss": mask_loss}
            if seg_logits is not None:
                seg_dice, seg_ce = loss_ops.fused_seg_loss(seg_logits, seg, cf.num_seg_classes,
                                                           space=self._seg_space(img.shape[2]))
                loss = loss + (seg_dice + seg_ce) / 2.0
                monitor.update({"seg_dice_loss": seg_dice, "loss": loss})
            max_half = max(cf.rpn_train_anchors_per_image // 2, 1)
            aux = {
                "maps": [m.detach() for m in maps] if with_masks else None,
                "flat_rois": flat_rois,
                "batch_ix": batch_ix,
                "cls_logits_all": cls_logits_all,
                "bbox_all": bbox_all,
                "seg_logits": None if seg_logits is None else seg_logits.detach(),
                "out_proposals": out_proposals,
                "prop_valid": prop_valid,
                "anchor_info": base.compact_anchor_indices(rpn_match, neg_sel, max_half, max_half),
                "sampled_rois": s_rois,
                "sampled_valid": s_valid,
                "sampled_class": s_class,
                "monitor": {k: v.detach() for k, v in monitor.items()},
            }
        return loss, aux

    def _finalize(self, aux, bsz: int, with_masks: bool = False):
        """Detection refinement of one microbatch's aux (``mrcnn.py:678-686``):
        (det, det_mask, det_masks_raw | None, seg_preds | None)."""
        with torch.no_grad():
            det, det_mask, det_masks_raw = self._detections_and_masks(
                aux["maps"], aux["flat_rois"], aux["batch_ix"], aux["cls_logits_all"], aux["bbox_all"], bsz,
                with_masks)
            seg_preds = None
            if aux["seg_logits"] is not None:
                seg_preds = torch.argmax(aux["seg_logits"], dim=1, keepdim=True).to(torch.uint8)
        return det, det_mask, det_masks_raw, seg_preds

    def _accumulate(self, inputs, draws):
        """Loss and gradients of one step: ``draws`` is ``self.draws``'
        tuple, one row per microbatch; grads land in the params' ``.grad``
        (``mrcnn.py:717-730``). Returns (mean loss, [aux per microbatch])."""
        n_micro = draws[0].shape[0]
        m = inputs[0].shape[0] // n_micro

        def micro(i):
            part = [None if t is None else t[i * m:(i + 1) * m] for t in inputs]
            return self._losses(part, [d[i] for d in draws])

        return base.accum_backward(list(self.module.parameters()), micro, n_micro)

    def _merge(self, auxs, m: int, with_masks: bool = False):
        """Refinement per microbatch (its ``batch_ix`` is microbatch-local),
        then the batch-leading outputs concatenated and the monitor values
        averaged (``mrcnn.py:735-754``)."""
        fin = [self._finalize(a, m, with_masks) for a in auxs]

        def cat(parts):
            return None if parts[0] is None else torch.cat(parts)

        outs = dict(zip(("det", "det_mask", "det_masks_raw", "seg_preds"), (cat(parts) for parts in zip(*fin))))
        for key in ("out_proposals", "prop_valid", "sampled_rois", "sampled_valid", "sampled_class"):
            outs[key] = cat([a[key] for a in auxs])
        outs["anchor_info"] = [cat(parts) for parts in zip(*(a["anchor_info"] for a in auxs))]
        monitor = {k: torch.stack([a["monitor"][k] for a in auxs]).mean() for k in auxs[0]["monitor"]}
        return monitor, outs

    def train_forward_dispatch(self, batch, is_validation: bool = False, do_update: bool = True):
        """Enqueue one step (the update unless validating), the detection
        refinement and the host copies of its small results (monitor values,
        sampled anchors, proposals and RoIs, detections); return handles that
        nothing has waited for yet. Validation returns masks when
        ``cf.return_masks_in_val``."""
        with_masks = bool(self.cf.return_masks_in_val) if is_validation else False
        validating = is_validation or not do_update
        rid = trace.request()
        with trace.span("dispatch", rid=rid, kind="val" if validating else "train"):
            with trace.span("upload"):
                inputs = self._prep(batch)
            bsz = inputs[0].shape[0]
            n_micro, m = self.step_layout(bsz, 1 if validating else None)
            draws = self.step_draws(n_micro, m)
            with self.data_parallel_step(n_micro):
                if validating:
                    with torch.no_grad():
                        _, aux = self._losses(inputs, [d[0] for d in draws], with_masks)
                    monitor, outs = self._merge([aux], bsz, with_masks)
                else:
                    _, auxs = self._accumulate(inputs, draws)
                    self._update()
                    monitor, outs = self._merge(auxs, bsz // n_micro)
            keys = list(monitor)
            small = ["det", "det_mask", "out_proposals", "prop_valid", "sampled_rois", "sampled_valid",
                     "sampled_class"]
            host, copied = base.start_host_copies([*monitor.values(), *outs["anchor_info"],
                                                   *(outs[k] for k in small)])
        n = len(keys)
        return base.Handles(rid, (tuple(inputs[0].shape), dict(zip(keys, host[:n])), host[n:n + 4],
                                  dict(zip(small, host[n + 4:])), outs["det_masks_raw"], outs["seg_preds"], with_masks,
                                  copied))

    def train_forward_convert(self, handles, batch, need_seg_preds: bool = True):
        """One step's handles -> the reference results dict
        (``mrcnn.py:821-858``, ``:909-929``): GT boxes, sampled anchors, the
        top ``n_plot_rpn_props`` proposals, the sampled RoIs as ``pos_class``
        / ``neg_class``, then the detections."""
        cf = self.cf
        img_shape, monitor, anchor_info, small, det_masks_raw, seg_preds, with_masks, copied = handles
        bsz = img_shape[0]
        with base.convert_span(handles):
            base.wait_for(copied, "host copies")
            with trace.span("assemble"):
                boxes = [[] for _ in range(bsz)]
                base.add_gt_boxes_to_results(batch, boxes)
                base.add_anchor_boxes_to_results(self.np_anchors, [t.numpy() for t in anchor_info], img_shape[2:],
                                                  boxes)
                props = small["out_proposals"].numpy()
                trace.count("proposals", int(np.count_nonzero(small["prop_valid"].numpy())))
                for b in range(bsz):
                    order = np.argsort(-props[b, :, -1])
                    for r in props[b][order][: getattr(cf, "n_plot_rpn_props", 5), :-1]:
                        boxes[b].append({"box_coords": r, "box_type": "prop"})
                srois, svalid, sclass = (small[k].numpy() for k in ("sampled_rois", "sampled_valid", "sampled_class"))
                for b in range(bsz):
                    for s in np.flatnonzero(svalid[b]):
                        boxes[b].append({"box_coords": srois[b, s] * np.asarray(cf.scale),
                                         "box_type": "pos_class" if sclass[b, s] > 0 else "neg_class"})
                det, det_mask = small["det"], small["det_mask"]
                base.detections_to_box_results(cf, det.numpy(), det_mask.numpy(), boxes)
                if need_seg_preds:
                    seg = self._make_seg_preds(det, det_mask, det_masks_raw, seg_preds, batch["data"].shape,
                                               with_masks)
                else:  # skip the full-volume copy
                    seg = np.zeros((bsz, 1) + tuple(batch["data"].shape[2:]), dtype=np.float32)
        monitor = {k: float(v) for k, v in monitor.items()}
        return {
            "boxes": boxes,
            "seg_preds": seg,
            "loss": monitor["loss"],
            "torch_loss": monitor["loss"],  # legacy key some callers expect
            "monitor_values": {"loss": monitor["loss"], "class_loss": monitor["class_loss"]},
            "logger_string": (
                "loss: {0:.2f}, rpn_class: {1:.2f}, rpn_bbox: {2:.2f}, mrcnn_class: {3:.2f}, "
                "mrcnn_bbox: {4:.2f}, mrcnn_mask: {5:.2f}".format(
                    monitor["loss"], monitor["rpn_class_loss"], monitor["rpn_bbox_loss"],
                    monitor["class_loss"], monitor["mrcnn_bbox_loss"], monitor.get("mrcnn_mask_loss", 0.0))
            ),
        }


@register("ufrcnn")
class UFRCNNDetector(MaskRCNNDetector):
    """U-Faster R-CNN+: Mask R-CNN without the mask head, with the
    operate_stride1 FPN and a P0 semantic-segmentation head in float32
    (``ufrcnn.py:18-21``)."""

    with_mask_head = False
    with_seg_head = True
