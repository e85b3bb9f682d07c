"""Mask R-CNN inference, 2D + 3D (torch); base of U-Faster R-CNN+.

Counterpart of the inference half of ``medicaldetectiontoolkit_tpu/models/
mrcnn.py``:
  * ``RPNHead``: shared 3x3 conv + 1x1 class (2A) / box (2*dim*A) convs per
    pyramid level, flattened in the anchor order of ``ops/anchors.py``;
  * ``ClassifierHead`` (pool_size conv -> 1x1 conv -> class logits and
    per-class box deltas) and ``MaskHead`` (4 conv3x3 -> deconv x2 -> 1x1
    conv -> sigmoid) on pooled RoIs;
  * ``pyramid_roi_align``: FPN level assignment, then the pyramid RoIAlign
    dispatcher (the CUDA kernel K2 for CUDA tensors);
  * ``proposal_layer``: per-element exact top-``pre_nms_limit`` by RPN
    foreground score, decode, clip, NMS at ``rpn_nms_threshold`` padded to
    ``post_nms_rois_inference`` (the NMS dispatcher: kernel K1 on the card);
  * ``refine_detections``: every proposal expanded for every foreground
    class, decode, clip, round, min-confidence filter, one NMS lane per
    (element, class), per-element top-k merge.

As in JAX, padded and invalid proposals are not masked out: padding slots
are zero boxes, classified and refined like the rest, and the mask pass runs
on every detection slot. Tensors are channel-first; masks come out
``(b, max_inst, n_classes, *mask_shape)``.

Training (detection targets, losses, K2's backward) is not ported yet
(ROADMAP.md, Queue 1).
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
from medicaldetectiontoolkit_torch.ops import nms as nms_ops
from medicaldetectiontoolkit_torch.ops import roi_align as roi_ops
from medicaldetectiontoolkit_torch.ops.losses import softmax
from medicaldetectiontoolkit_torch.ops.topk import top_k


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
        # channel-last flatten: rows in (y, x, (z), anchor) order
        logits = self.logits(x).movedim(1, -1).reshape(b, -1, 2)
        deltas = self.deltas(x).movedim(1, -1).reshape(b, -1, 2 * self.dim)
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
                 num_seg_classes=0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.operate_stride1 = operate_stride1
        self.pyramid_levels = tuple(pyramid_levels)
        self.pool_size = tuple(pool_size)
        self.mask_pool_size = tuple(mask_pool_size)
        self.fpn = FPN(dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                       operate_stride1, dtype=dtype)
        self.rpn = RPNHead(dim, end_filts, n_rpn_features, n_anchors_per_pos, anchor_stride, relu, dtype=dtype)
        self.classifier = ClassifierHead(dim, end_filts, pool_size, head_classes, norm, relu, dtype=dtype)
        self.mask = MaskHead(dim, end_filts, head_classes, norm, relu, dtype=dtype) if with_mask_head else None
        # the seg head runs in float32 whatever the compute dtype
        self.final_conv = (
            ConvND(dim, end_filts, num_seg_classes, ks=1, relu=None, dtype=torch.float32)
            if num_seg_classes else None
        )

    def extract(self, img):
        """img -> (feature maps, rpn_logits (b, A, 2), rpn_deltas (b, A, 2d), seg_logits)."""
        fpn_outs = self.fpn(img.to(self.dtype))
        seg_logits = self.final_conv(fpn_outs[0]) if self.final_conv is not None else None
        offset = 1 if self.operate_stride1 else 0
        maps = [fpn_outs[i + offset] for i in self.pyramid_levels]
        outs = [self.rpn(p) for p in maps]
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
        ).to(self.device).eval()

    def init_params(self, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        init_weights(self.module, self.cf.weight_init, gen)
        # the classifier's first conv is a bare flax nn.Conv: flax's default
        # init (lecun_normal) whatever cf.weight_init says (mrcnn.py:95-97)
        init_weights(self.module.classifier.conv1.conv, None, gen)

    # ---- forward -----------------------------------------------------------
    def _proposals(self, rpn_logits, rpn_deltas):
        """(normalised proposals (b, P, 2d), out_proposals, valid) of the
        RPN heads (``mrcnn.py:526-534``, inference)."""
        rpn_probs_fg = softmax(rpn_logits)[..., 1]
        return proposal_layer(rpn_probs_fg, rpn_deltas, self.anchors, self.cf, self.cf.post_nms_rois_inference,
                              nms_fn=self.nms_fn)

    def _second_stage_all(self, maps, rois_norm):
        """Classify every proposal in chunks of ``cf.roi_chunk_size`` RoIs
        (``mrcnn.py:536-567``): R is padded with zero boxes on element 0 to
        a multiple of the chunk, so every chunk has one shape."""
        bsz, P = rois_norm.shape[:2]
        flat_rois = rois_norm.reshape(-1, rois_norm.shape[-1])
        batch_ix = torch.arange(bsz, dtype=torch.int32, device=rois_norm.device).repeat_interleave(P)
        chunk = getattr(self.cf, "roi_chunk_size", None)
        R = flat_rois.shape[0]
        if chunk and R > chunk:
            pad = (-R) % chunk
            rois_c = F.pad(flat_rois, (0, 0, 0, pad))
            bix_c = F.pad(batch_ix, (0, pad))
            outs = [self.module.classify_rois(maps, rois_c[i:i + chunk], bix_c[i:i + chunk], self.align_fn)
                    for i in range(0, R + pad, chunk)]
            logits = torch.cat([o[0] for o in outs])[:R]
            bbox = torch.cat([o[1] for o in outs])[:R]
        else:
            logits, bbox = self.module.classify_rois(maps, flat_rois, batch_ix, self.align_fn)
        return logits, bbox, flat_rois, batch_ix

    def _detections_and_masks(self, maps, flat_rois, batch_ix, logits, bbox, bsz, with_masks: bool):
        cf = self.cf
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
        return self._from_heads(self.module.extract(img), img.shape[0], with_masks)

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
            return seg_preds.cpu().numpy()
        spatial = tuple(data_shape[2:])
        seg = np.zeros((data_shape[0], 1) + spatial, dtype=np.uint8)
        if det_masks_raw is None:
            return seg.astype(np.float32) if not with_masks else seg
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


@register("ufrcnn")
class UFRCNNDetector(MaskRCNNDetector):
    """U-Faster R-CNN+: Mask R-CNN without the mask head, with the
    operate_stride1 FPN and a P0 semantic-segmentation head in float32
    (``ufrcnn.py:18-21``)."""

    with_mask_head = False
    with_seg_head = True
