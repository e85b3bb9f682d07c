"""RetinaNet / Retina U-Net inference, 2D + 3D (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/models/retina_net.py``:
  * ``DenseHead``: 4 conv3x3(+relu) -> conv3x3 with A*out channels, shared
    across pyramid levels, flattened in the anchor order of
    ``ops/anchors.py`` (positions (y, x, (z)) major, anchor minor);
  * ``RetinaModule``: FPN + class/box heads on P2.. (+ the P0 segmentation
    head of Retina U-Net);
  * ``refine_detections``: batch-global exact top-``pre_nms_limit`` over
    foreground probabilities, delta decode, window clip, round, one NMS lane
    per (element, class) through the NMS dispatcher (the CUDA kernel for
    CUDA tensors), then a per-element top-k merge.

Training (matching, SHEM, losses) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from medicaldetectiontoolkit_torch.models import base, register
from medicaldetectiontoolkit_torch.models.backbone import FPN, ConvND, init_weights
from medicaldetectiontoolkit_torch.ops import anchors as anchor_ops
from medicaldetectiontoolkit_torch.ops import boxes as box_ops
from medicaldetectiontoolkit_torch.ops import nms as nms_ops


class DenseHead(nn.Module):
    """Per-level dense prediction subnet (``retina_net.py:40-73``)."""

    def __init__(self, dim, cin, n_features, out_per_anchor, n_anchors_per_pos, anchor_stride=1,
                 relu="relu", dtype=torch.float32):
        super().__init__()
        kw = dict(ks=3, stride=anchor_stride, pad=1, dtype=dtype)
        self.convs = nn.Sequential(
            *[ConvND(dim, cin if i == 0 else n_features, n_features, relu=relu, **kw) for i in range(4)]
        )
        self.final = ConvND(dim, n_features, n_anchors_per_pos * out_per_anchor, relu=None, **kw)
        self.out_per_anchor = out_per_anchor

    def forward(self, x):
        x = self.final(self.convs(x))
        # channel-last flatten: rows in (y, x, (z), anchor) order
        return x.movedim(1, -1).reshape(x.shape[0], -1, self.out_per_anchor)


class RetinaModule(nn.Module):
    """FPN + shared dense heads (+ optional P0 segmentation head)
    (``retina_net.py:76-139``)."""

    def __init__(self, dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                 operate_stride1, head_classes, n_rpn_features, n_anchors_per_pos, anchor_stride,
                 pyramid_levels: Sequence[int], num_seg_classes=0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pyramid_levels = tuple(pyramid_levels)
        # P0 is prepended with operate_stride1; detection heads read P2..
        self.level_offset = 1 if operate_stride1 else 0
        self.fpn = FPN(dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                       operate_stride1, dtype=dtype)
        # the segmentation head runs in float32 whatever the compute dtype
        self.seg_head = (
            ConvND(dim, end_filts, num_seg_classes, ks=1, relu=None, dtype=torch.float32)
            if num_seg_classes else None
        )
        head = dict(n_anchors_per_pos=n_anchors_per_pos, anchor_stride=anchor_stride, relu=relu, dtype=dtype)
        self.cls_head = DenseHead(dim, end_filts, n_rpn_features, head_classes, **head)
        self.box_head = DenseHead(dim, end_filts, n_rpn_features, 2 * dim, **head)

    def forward(self, img):
        fpn_outs = self.fpn(img.to(self.dtype))
        seg_logits = self.seg_head(fpn_outs[0]) if self.seg_head is not None else None
        selected = [fpn_outs[i + self.level_offset] for i in self.pyramid_levels]
        class_logits = torch.cat([self.cls_head(p) for p in selected], dim=1).float()
        bb_deltas = torch.cat([self.box_head(p) for p in selected], dim=1).float()
        return class_logits, bb_deltas, seg_logits


def _softmax(logits):
    """softmax over the last axis in ``jax.nn.softmax``'s operation order."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _stable_topk(x, k: int, dim: int = -1):
    """Exact top-k with JAX's ``lax.top_k`` tie order (lower index first):
    a stable descending sort, sliced. ``torch.topk`` promises no tie order."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def refine_detections(anchors, class_logits, pred_deltas, cf, nms_fn=nms_ops.batched_nms_auto):
    """Batch-global candidate selection + per-(element, class) NMS
    (``retina_net.py:142-209``).

    anchors (A, 2*dim) float32 pixel coords; class_logits (b, A, C) and
    pred_deltas (b, A, 2*dim) float32, all on one device. Returns
    (detections (b, max_inst, 2*dim + 2), mask (b, max_inst)) where the
    trailing channels are (pred_class_id, score). ``nms_fn`` defaults to the
    device-keyed dispatcher.
    """
    bsz, A, C = class_logits.shape
    n_fg = C - 1
    dev = class_logits.device
    max_inst = cf.model_max_instances_per_batch_element
    k = min(cf.pre_nms_limit, bsz * A * n_fg)

    flat = _softmax(class_logits)[..., 1:].reshape(-1)
    # exact top-k: flat index order is (elem, anchor, class), so an
    # approximate selection would drop the weaker class of the same anchor
    scores, flat_ix = _stable_topk(flat, k)
    cand_elem = flat_ix // (A * n_fg)
    rem = flat_ix % (A * n_fg)
    cand_anchor = rem // n_fg
    cand_class = rem % n_fg + 1

    scale = base.host_to_device(np.asarray(cf.scale), dev)
    std = base.host_to_device(np.asarray(cf.rpn_bbox_std_dev), dev)
    window = base.host_to_device(np.asarray(cf.window), dev)
    anc = anchors[cand_anchor] / scale
    dts = pred_deltas[cand_elem, cand_anchor] * std
    boxes = box_ops.apply_box_deltas(anc, dts) * scale
    boxes = torch.round(box_ops.clip_boxes(boxes, window))  # half-to-even, as jnp.round

    # one NMS lane per (element, class); boxes and scores are broadcast to
    # every lane (stride 0), the lane's own candidates marked valid
    n_lanes = bsz * n_fg
    lane_elem = torch.arange(bsz, device=dev).repeat_interleave(n_fg)
    lane_class = torch.arange(1, C, device=dev).repeat(bsz)
    lane_valid = (cand_elem[None, :] == lane_elem[:, None]) & (cand_class[None, :] == lane_class[:, None])
    lane_idx, lane_mask = nms_fn(
        boxes.expand(n_lanes, k, boxes.shape[-1]), scores.expand(n_lanes, k),
        cf.detection_nms_threshold, max_inst, valid=lane_valid,
    )
    lane_idx = lane_idx.reshape(bsz, n_fg * max_inst).long()
    lane_mask = lane_mask.reshape(bsz, n_fg * max_inst)

    merged_scores = torch.where(lane_mask, scores[lane_idx.clamp(0, k - 1)], float("-inf"))
    _, top_pos = _stable_topk(merged_scores, max_inst, dim=1)
    final_idx = torch.take_along_dim(lane_idx, top_pos, dim=1).clamp(0, k - 1)
    final_mask = torch.take_along_dim(lane_mask, top_pos, dim=1)

    det = torch.cat(
        [boxes[final_idx], cand_class[final_idx][..., None].to(torch.float32), scores[final_idx][..., None]],
        dim=-1,
    )
    return det, final_mask


@register("retina_net")
class RetinaNetDetector(base.Detector):
    """Host-facing RetinaNet with the reference's test_forward API."""

    with_seg_head = False

    def build(self):
        cf = self.cf
        h, w = cf.patch_size[:2]
        if h % 2**5 or w % 2**5:
            raise ValueError("patch size must be divisible by 2**5 (e.g. 256, 320, 384, ...)")
        self.anchors = anchor_ops.generate_pyramid_anchors(cf, self.logger).to(self.device, torch.float32)
        self.module = RetinaModule(
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
            n_anchors_per_pos=cf.n_anchors_per_pos,
            anchor_stride=cf.rpn_anchor_stride,
            pyramid_levels=cf.pyramid_levels,
            num_seg_classes=cf.num_seg_classes if self.with_seg_head else 0,
            dtype=torch.bfloat16 if cf.compute_dtype == "bfloat16" else torch.float32,
        ).to(self.device).eval()

    def init_params(self, seed: int = 0):
        init_weights(self.module, self.cf.weight_init, torch.Generator().manual_seed(seed))

    def _predict(self, img):
        return self.module(img)

    def _finalize_outputs(self, class_logits, bb_deltas, seg_logits):
        det, det_mask = refine_detections(self.anchors, class_logits, bb_deltas, self.cf)
        seg_preds = None
        if seg_logits is not None:
            seg_preds = torch.argmax(seg_logits, dim=1, keepdim=True).to(torch.uint8)  # (b, 1, *spatial)
        return det, det_mask, seg_preds


@register("retina_unet")
class RetinaUNetDetector(RetinaNetDetector):
    """Retina U-Net: RetinaNet + operate_stride1 FPN + P0 segmentation head."""

    with_seg_head = True
