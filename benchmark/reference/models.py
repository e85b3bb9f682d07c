"""Plain PyTorch reference of the benchmarked detectors: the FPN backbone,
3D Retina U-Net and 3D Mask R-CNN, their inference and one training step.

A frozen copy of the measured package's model code (which its CPU tests
hold against the original toolkit's JAX port), cut to one process and to
plain operations: no data-parallel or spatial collectives, no CUDA kernel,
float32 only. Module and parameter names are the measured package's, so one
state dict loads into both. It imports nothing of the measured package.

``RetinaUNet`` and ``MaskRCNN`` take the config namespace the benchmark
builds; ``infer`` gives every refinement candidate (for the comparison of
served detections), ``refine`` the served detections of them, ``loss`` one
step's loss; ``train_steps`` runs the first optimizer steps.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import ops

# flax nn.GroupNorm's default epsilon, as the measured package takes it
GN_EPS = 1e-6


def _group_norm(x, norm: nn.GroupNorm):
    """GroupNorm with the fast variance E[x^2] - E[x]^2 clamped at 0, its
    sums in float64."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xg = x.float().reshape(b, g, c // g, -1)
    xd = xg.double()
    n = xg.shape[2] * xg.shape[3]
    mean, mean_sq = (torch.stack([xd.sum(dim=(2, 3)), xd.square().sum(dim=(2, 3))]) / n)[..., None, None]
    var = torch.clamp_min(mean_sq - mean.square(), 0.0).float()
    mul = torch.rsqrt(var + norm.eps) * norm.weight.view(1, g, c // g, 1)
    return ((xg - mean.float()) * mul + norm.bias.view(1, g, c // g, 1)).reshape(x.shape)


def _maybe_remat(module, fn, x):
    if module.remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


class ConvND(nn.Module):
    """conv + optional GroupNorm + optional nonlinearity."""

    def __init__(self, dim, cin, cout, ks=1, stride=1, pad=0, norm=None, relu="relu", remat=False):
        super().__init__()
        self.conv = (nn.Conv2d if dim == 2 else nn.Conv3d)(cin, cout, ks, stride=stride, padding=pad)
        self.norm = {"batch_norm": lambda: nn.GroupNorm(1, cout, eps=GN_EPS),
                     "instance_norm": lambda: nn.GroupNorm(cout, cout, eps=GN_EPS),
                     None: lambda: None}[norm]()
        self.relu = relu
        self.remat = remat

    def forward(self, x):
        return _maybe_remat(self, self._forward, x)

    def _forward(self, x):
        c = self.conv
        x = (F.conv2d if isinstance(c, nn.Conv2d) else F.conv3d)(x, c.weight, c.bias, c.stride, c.padding)
        if self.norm is not None:
            x = _group_norm(x, self.norm)
        if self.relu == "relu":
            x = F.relu(x)
        elif self.relu == "leaky_relu":
            x = F.leaky_relu(x, 0.01)
        return x


class ResBlock(nn.Module):
    """Bottleneck block: 1x1 (stride) -> 3x3 -> 1x1 x4 + residual."""

    def __init__(self, dim, cin, planes, stride=1, downsample=False, norm=None, relu="relu", remat=False):
        super().__init__()
        self.conv1 = ConvND(dim, cin, planes, ks=1, stride=stride, norm=norm, relu=relu)
        self.conv2 = ConvND(dim, planes, planes, ks=3, pad=1, norm=norm, relu=relu)
        self.conv3 = ConvND(dim, planes, planes * 4, ks=1, norm=norm, relu=None)
        self.downsample = ConvND(dim, cin, planes * 4, ks=1, stride=stride, norm=norm, relu=None) if downsample else None
        self.relu = relu
        self.remat = remat

    def forward(self, x):
        return _maybe_remat(self, self._forward, x)

    def _forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        out = out + (self.downsample(x) if self.downsample is not None else x)
        return F.relu(out) if self.relu == "relu" else F.leaky_relu(out, 0.01)


def res_stage(dim, cin, planes, n_blocks, stride, norm, relu, remat):
    blocks = [ResBlock(dim, cin, planes, stride, True, norm, relu, remat)]
    blocks += [ResBlock(dim, planes * 4, planes, 1, False, norm, relu, remat) for _ in range(n_blocks - 1)]
    return nn.Sequential(*blocks)


class FPN(nn.Module):
    """ResNet-50/101 encoder and top-down decoder: [P0, P2..P5] with
    ``operate_stride1``, [P2..P5] without; in 3D the stem and max pool
    stride (2, 2, 1) and the stride-1 levels up-sample trilinearly."""

    def __init__(self, cf, remat):
        super().__init__()
        dim, sf, ef = cf.dim, cf.start_filts, cf.end_filts
        self.dim = dim
        self.operate_stride1 = cf.operate_stride1
        n_blocks = [3, 4, {"resnet50": 6, "resnet101": 23}[cf.res_architecture], 3]
        kw = dict(norm=cf.norm, relu=cf.relu)
        stem_stride = (2, 2, 1) if dim == 3 else 2
        if cf.operate_stride1:
            self.stem0 = nn.Sequential(ConvND(dim, cf.n_channels, sf, ks=3, pad=1, remat=remat, **kw),
                                       ConvND(dim, sf, sf, ks=3, pad=1, remat=remat, **kw))
            self.stem1 = ConvND(dim, sf, sf, ks=7, stride=stem_stride, pad=3, remat=remat, **kw)
        else:
            self.stem0 = None
            self.stem1 = ConvND(dim, cf.n_channels, sf, ks=7, stride=stem_stride, pad=3, remat=remat, **kw)
        stages = [(sf, sf, 1), (sf * 4, sf * 2, 2), (sf * 8, sf * 4, 2), (sf * 16, sf * 8, 2)]
        if cf.sixth_pooling:
            stages.append((sf * 32, sf * 16, 2))
            n_blocks.append(n_blocks[3])
        self.stages = nn.ModuleList(res_stage(dim, cin, planes, nb, stride, remat=remat, **kw)
                                    for (cin, planes, stride), nb in zip(stages, n_blocks))
        c_out = [sf * 4, sf * 8, sf * 16, sf * 32] + ([sf * 64] if cf.sixth_pooling else [])
        self.lateral = nn.ModuleList(ConvND(dim, c, ef, ks=1, relu=None) for c in c_out)
        self.out = nn.ModuleList(ConvND(dim, ef, ef, ks=3, pad=1, relu=None) for _ in c_out)
        if cf.operate_stride1:
            self.lateral1 = ConvND(dim, sf, ef, ks=1, relu=None, remat=remat)
            self.lateral0 = ConvND(dim, sf, ef, ks=1, relu=None, remat=remat)
            self.out0 = ConvND(dim, ef, ef, ks=3, pad=1, relu=None, remat=remat)

    def forward(self, x):
        d = self.dim
        c0 = self.stem0(x) if self.operate_stride1 else x
        c1 = self.stem1(c0)
        h = (F.max_pool3d(c1, 3, stride=(2, 2, 1), padding=1) if d == 3 else F.max_pool2d(c1, 3, stride=2, padding=1))
        cs = []
        for stage in self.stages:
            h = stage(h)
            cs.append(h)
        pre = [None] * len(cs)
        pre[-1] = self.lateral[-1](cs[-1])
        for i in range(len(cs) - 2, -1, -1):
            up = F.interpolate(pre[i + 1], size=[s * 2 for s in pre[i + 1].shape[2:]], mode="nearest")
            pre[i] = self.lateral[i](cs[i]) + up
        out = [conv(p) for conv, p in zip(self.out, pre)]
        if self.operate_stride1:
            aniso = (2, 2, 1) if d == 3 else (2, 2)
            mode = "trilinear" if d == 3 else "bilinear"

            def up(t):
                return F.interpolate(t, size=[s * f for s, f in zip(t.shape[2:], aniso)], mode=mode,
                                     align_corners=False)

            p1_pre = self.lateral1(c1) + up(pre[0])
            p0_pre = self.lateral0(c0) + up(p1_pre)
            out = [self.out0(p0_pre)] + out
        return out


def _flatten_heads(x, per_anchor):
    """(b, A*per_anchor, *spatial) -> (b, positions*A, per_anchor), rows in
    (y, x, (z), anchor) order, the order of ``ops.generate_pyramid_anchors``."""
    return x.movedim(1, -1).reshape(x.shape[0], -1, per_anchor)


def refine(cf, cand, bsz):
    """The served detections of a batch's candidates: greedy NMS in one lane
    per (element, class) at ``detection_nms_threshold``, then each
    element's ``model_max_instances_per_batch_element`` best by score.
    Returns (det (b, max_inst, 8) = box, class, score; valid (b, max_inst))."""
    n_fg, max_inst = cf.head_classes - 1, cf.model_max_instances_per_batch_element
    dev, n = cand["score"].device, cand["score"].shape[0]
    lanes = bsz * n_fg
    lane_elem = torch.arange(bsz, device=dev).repeat_interleave(n_fg)
    lane_cls = torch.arange(1, n_fg + 1, device=dev).repeat(bsz)
    valid = (cand["elem"][None, :] == lane_elem[:, None]) & (cand["cls"][None, :] == lane_cls[:, None])
    idx, keep = ops.batched_nms(cand["box"].expand(lanes, n, 6), cand["score"].expand(lanes, n),
                                cf.detection_nms_threshold, max_inst, valid=valid)
    idx, keep = idx.reshape(bsz, -1).long(), keep.reshape(bsz, -1)
    merged = torch.where(keep, cand["score"][idx.clamp(0, n - 1)], float("-inf"))
    _, top = ops.top_k(merged, max_inst, dim=1)
    final = torch.take_along_dim(idx, top, dim=1).clamp(0, n - 1)
    det = torch.cat([cand["box"][final], cand["cls"][final][..., None].to(torch.float32),
                     cand["score"][final][..., None]], dim=-1)
    return det, torch.take_along_dim(keep, top, dim=1)


# ---------------------------------------------------------------- Retina U-Net

class DenseHead(nn.Module):
    def __init__(self, dim, cin, n_features, out_per_anchor, n_anchors, relu):
        super().__init__()
        self.convs = nn.Sequential(*[ConvND(dim, cin if i == 0 else n_features, n_features, ks=3, pad=1, relu=relu)
                                     for i in range(4)])
        self.final = ConvND(dim, n_features, n_anchors * out_per_anchor, ks=3, pad=1, relu=None)
        self.out_per_anchor = out_per_anchor

    def forward(self, x):
        return _flatten_heads(self.final(self.convs(x)), self.out_per_anchor)


class RetinaModule(nn.Module):
    def __init__(self, cf, remat):
        super().__init__()
        self.pyramid_levels = tuple(cf.pyramid_levels)
        self.level_offset = 1 if cf.operate_stride1 else 0
        self.fpn = FPN(cf, remat)
        self.seg_head = ConvND(cf.dim, cf.end_filts, cf.num_seg_classes, ks=1, relu=None)
        self.cls_head = DenseHead(cf.dim, cf.end_filts, cf.n_rpn_features, cf.head_classes, cf.n_anchors_per_pos,
                                  cf.relu)
        self.box_head = DenseHead(cf.dim, cf.end_filts, cf.n_rpn_features, 2 * cf.dim, cf.n_anchors_per_pos,
                                  cf.relu)

    def forward(self, img):
        outs = self.fpn(img)
        maps = [outs[i + self.level_offset] for i in self.pyramid_levels]
        class_logits = torch.cat([self.cls_head(m) for m in maps], dim=1)
        bb_deltas = torch.cat([self.box_head(m) for m in maps], dim=1)
        return class_logits, bb_deltas, self.seg_head(outs[0])


def _tensor(cf, name, device):
    return torch.as_tensor([float(v) for v in getattr(cf, name)], dtype=torch.float32, device=device)


class RetinaUNet:
    """3D Retina U-Net: the FPN with the stride-1 levels, the shared class and
    box heads on P2..P5 and the P0 seg head."""

    def __init__(self, cf, device, remat=True):
        self.cf = cf
        self.device = torch.device(device)
        self.module = RetinaModule(cf, remat).to(self.device)
        self.anchors = ops.generate_pyramid_anchors(cf).to(self.device, torch.float32)

    def candidates(self, class_logits, bb_deltas):
        """Every refinement candidate of a batch: the exact batch-global
        top-``pre_nms_limit`` foreground scores, their element, class and
        decoded, clipped, rounded boxes (float32)."""
        cf = self.cf
        bsz, A, C = class_logits.shape
        n_fg = C - 1
        k = min(cf.pre_nms_limit, bsz * A * n_fg)
        scores, flat_ix = ops.top_k(ops.softmax(class_logits)[..., 1:].reshape(-1), k)
        elem = flat_ix // (A * n_fg)
        anchor = (flat_ix % (A * n_fg)) // n_fg
        cls = flat_ix % n_fg + 1
        scale, std, window = (_tensor(cf, n, self.device) for n in ("scale", "rpn_bbox_std_dev", "window"))
        boxes = ops.apply_box_deltas(self.anchors[anchor] / scale, bb_deltas[elem, anchor] * std) * scale
        boxes = torch.round(ops.clip_boxes(boxes, window))
        return {"elem": elem, "cls": cls, "score": scores, "box": boxes}

    def refine(self, cand, bsz):
        return refine(self.cf, cand, bsz)

    @torch.no_grad()
    def infer(self, img):
        """img (b, 1, y, x, z) -> (candidates, seg logits (b, C, y, x, z))."""
        class_logits, bb_deltas, seg_logits = self.module(img)
        return self.candidates(class_logits, bb_deltas), seg_logits

    def draws(self, generator, bsz):
        cf = self.cf
        A = self.anchors.shape[0]
        k_pool = min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A)
        kw = dict(generator=generator, device=self.device)
        return torch.rand((1, bsz, A), **kw)[0], torch.rand((1, bsz, k_pool), **kw)[0]

    def loss(self, batch, draws):
        """The loss of one step on ``batch`` (image, GT boxes, ids, valid,
        seg labels, on the device) with ``draws`` (matching, SHEM)."""
        cf = self.cf
        img, gt_boxes, gt_ids, gt_valid, seg = batch
        match_rand, shem_rand = draws
        class_logits, bb_deltas, seg_logits = self.module(img)
        std = _tensor(cf, "rpn_bbox_std_dev", self.device)
        matches, tdeltas = ops.gt_anchor_matching(match_rand, self.anchors, gt_boxes, gt_ids, gt_valid,
                                                  cf.anchor_matching_iou, 0.01, cf.rpn_train_anchors_per_image, std)
        class_losses, _ = ops.anchor_class_loss(shem_rand, matches, class_logits, cf.shem_poolsize,
                                                cf.rpn_train_anchors_per_image // 2)
        loss = class_losses.mean() + ops.anchor_bbox_loss(tdeltas, bb_deltas, matches).mean()
        seg_dice, seg_ce = ops.fused_seg_loss(seg_logits, seg, cf.num_seg_classes)
        return loss + (seg_dice + seg_ce) / 2.0


# ------------------------------------------------------------------ Mask R-CNN

class RPNHead(nn.Module):
    def __init__(self, dim, cin, n_features, n_anchors, relu):
        super().__init__()
        self.conv = ConvND(dim, cin, n_features, ks=3, pad=1, relu=relu)
        self.logits = ConvND(dim, n_features, 2 * n_anchors, ks=1, relu=None)
        self.deltas = ConvND(dim, n_features, 2 * dim * n_anchors, ks=1, relu=None)
        self.dim = dim

    def forward(self, x):
        x = self.conv(x)
        return _flatten_heads(self.logits(x), 2), _flatten_heads(self.deltas(x), 2 * self.dim)


class ClassifierHead(nn.Module):
    def __init__(self, dim, end_filts, pool_size, head_classes, norm, relu):
        super().__init__()
        norm = norm if norm != "instance_norm" else None
        self.conv1 = ConvND(dim, end_filts, end_filts * 4, ks=tuple(pool_size), norm=norm, relu=relu)
        self.conv2 = ConvND(dim, end_filts * 4, end_filts * 4, ks=1, norm=norm, relu=relu)
        self.cls = nn.Linear(end_filts * 4, head_classes)
        self.bbox = nn.Linear(end_filts * 4, head_classes * 2 * dim)
        self.dim, self.head_classes = dim, head_classes

    def forward(self, pooled):
        x = self.conv2(self.conv1(pooled)).reshape(pooled.shape[0], -1)
        return self.cls(x), self.bbox(x).reshape(-1, self.head_classes, 2 * self.dim)


class MaskHead(nn.Module):
    def __init__(self, dim, end_filts, head_classes, norm, relu):
        super().__init__()
        self.convs = nn.Sequential(*[ConvND(dim, end_filts, end_filts, ks=3, pad=1, norm=norm, relu=relu)
                                     for _ in range(4)])
        self.deconv = (nn.ConvTranspose2d if dim == 2 else nn.ConvTranspose3d)(end_filts, end_filts, 2, stride=2)
        self.final = ConvND(dim, end_filts, head_classes, ks=1, relu=None)
        self.relu = relu

    def forward(self, pooled):
        x = self.deconv(self.convs(pooled))
        x = F.relu(x) if self.relu == "relu" else F.leaky_relu(x, 0.01)
        return torch.sigmoid(self.final(x))


class MRCNNModule(nn.Module):
    def __init__(self, cf, remat):
        super().__init__()
        self.operate_stride1 = cf.operate_stride1
        self.pyramid_levels = tuple(cf.pyramid_levels)
        self.pool_size, self.mask_pool_size = tuple(cf.pool_size), tuple(cf.mask_pool_size)
        self.fpn = FPN(cf, remat)
        self.rpn = RPNHead(cf.dim, cf.end_filts, cf.n_rpn_features, len(cf.rpn_anchor_ratios), cf.relu)
        self.classifier = ClassifierHead(cf.dim, cf.end_filts, cf.pool_size, cf.head_classes, cf.norm, cf.relu)
        self.mask = MaskHead(cf.dim, cf.end_filts, cf.head_classes, cf.norm, cf.relu)

    def extract(self, img):
        outs = self.fpn(img)
        off = 1 if self.operate_stride1 else 0
        maps = [outs[i + off] for i in self.pyramid_levels]
        heads = [self.rpn(m) for m in maps]
        return maps, torch.cat([h[0] for h in heads], dim=1), torch.cat([h[1] for h in heads], dim=1)

    def align(self, maps, boxes_norm, batch_ix, pool_size):
        return ops.pyramid_roi_align(maps, boxes_norm, batch_ix, roi_levels(boxes_norm, self.pyramid_levels),
                                     tuple(pool_size))


def roi_levels(boxes_norm, pyramid_levels):
    """FPN level index of each RoI: clamp(round(4 + log2(sqrt(h*w))))."""
    h = boxes_norm[:, 2] - boxes_norm[:, 0]
    w = boxes_norm[:, 3] - boxes_norm[:, 1]
    hw = torch.clamp_min(h * w, 1e-12)
    log2 = torch.tensor(math.log(2.0), dtype=torch.float32, device=boxes_norm.device)
    level = torch.round(4.0 + torch.log(torch.sqrt(hw)) / log2).to(torch.int32)
    level = torch.clamp(level, pyramid_levels[0], pyramid_levels[-1])
    if len(pyramid_levels) == 5:
        level = torch.where(hw > 0.65, 5, level)
    return level - pyramid_levels[0]


def proposal_layer(cf, anchors, rpn_probs_fg, rpn_deltas, proposal_count):
    """Per element: top-``pre_nms_limit`` RPN scores, decode, clip, NMS at
    ``rpn_nms_threshold``, zero boxes past the kept ones. Returns
    (normalised proposals (b, P, 2d), valid (b, P))."""
    dev = rpn_probs_fg.device
    k = min(cf.pre_nms_limit, anchors.shape[0])
    top_scores, order = ops.top_k(rpn_probs_fg, k, dim=1)
    deltas = torch.take_along_dim(rpn_deltas, order[..., None], dim=1) * _tensor(cf, "rpn_bbox_std_dev", dev)
    boxes = ops.clip_boxes(ops.apply_box_deltas(anchors[order], deltas), _tensor(cf, "window", dev))
    keep_idx, keep_mask = ops.batched_nms(boxes, top_scores, cf.rpn_nms_threshold, proposal_count)
    safe = keep_idx.long().clamp(0, k - 1)
    out = torch.where(keep_mask[..., None], torch.take_along_dim(boxes, safe[..., None], dim=1), 0.0)
    return out / _tensor(cf, "scale", dev), keep_mask


def roi_slots(cf):
    n_pos = max(1, int(cf.train_rois_per_image * cf.roi_positive_ratio))
    return n_pos, max(1, int(n_pos * (1.0 / cf.roi_positive_ratio - 1.0)))


def _lowest(key, k):
    """Indices of the ``k`` smallest keys, ties to the lower index, and
    whether each is finite."""
    neg_vals, idx = ops.top_k(-key, k)
    return idx, torch.isfinite(neg_vals)


def _flat_mean(values, mask):
    mask = mask.to(values.dtype)
    total, count = (values * mask).sum(), mask.sum()
    return torch.where(count > 0, total / count.clamp_min(1.0), 0.0)


def detection_targets(cf, draws, proposals, prop_valid, class_scores, gt_boxes_norm, gt_ids, gt_valid, gt_masks):
    """Sample positive RoIs by IoU with the GTs and negatives by SHEM on the
    predicted fg scores; their class, delta and mask targets."""
    pos_rand, shem_rand, neg_rand = draws
    bsz, dev = proposals.shape[0], proposals.device
    n_pos_slots, n_neg_slots = roi_slots(cf)
    any_gt = gt_valid.any(dim=1, keepdim=True)
    overlaps = torch.where(gt_valid[:, None, :], ops.pairwise_iou(proposals, gt_boxes_norm), -1.0)
    iou_max = overlaps.amax(dim=2)
    pos_idx, pos_valid = _lowest(torch.where((iou_max >= 0.3) & any_gt, pos_rand, float("inf")), n_pos_slots)
    n_pos = pos_valid.sum(dim=1)
    assignment = torch.argmax(torch.take_along_dim(overlaps, pos_idx[..., None], dim=1), dim=2)
    pos_rois = torch.take_along_dim(proposals, pos_idx[..., None], dim=1)
    gt_of = torch.take_along_dim(gt_boxes_norm, assignment[..., None], dim=1)
    safe_gt = torch.where(pos_valid[..., None], gt_of, pos_rois + 1e-3)
    eps = torch.tensor([0.0, 0.0, 1e-3, 1e-3, 0.0, 1e-3], dtype=torch.float32, device=dev)
    safe_rois = torch.where((ops.box_area(pos_rois) > 0)[..., None], pos_rois, pos_rois + eps)
    deltas = torch.where(pos_valid[..., None],
                         ops.box_refinement(safe_rois, safe_gt) / _tensor(cf, "bbox_std_dev", dev), 0.0)
    cls_pos = torch.where(pos_valid, torch.gather(gt_ids.to(torch.int32), 1, assignment), 0)

    n_masks = gt_masks.shape[1]
    mask_pos = pos_valid & (assignment < n_masks)
    shape = tuple(cf.mask_shape)
    axes = ops.roi_axes(pos_rois.reshape(-1, 6), shape, gt_masks.shape[2:])
    ys = torch.stack(axes[0][:2]).long().reshape(2, bsz, n_pos_slots, shape[0])
    b_ix = torch.arange(bsz, device=dev)[:, None, None]
    rows = gt_masks[b_ix, assignment.clamp(0, n_masks - 1)[..., None], ys].to(torch.float32)
    rows = rows.reshape(2, bsz * n_pos_slots, shape[0], *gt_masks.shape[3:], 1)
    crops = ops.roi_lerp(rows[0], rows[1], axes, shape)[:, 0].reshape(bsz, n_pos_slots, *shape)
    masks = torch.round(torch.where(mask_pos.reshape(bsz, n_pos_slots, 1, 1, 1), crops, 0.0))

    fg = class_scores[..., 1:].amax(dim=-1)
    neg_count = torch.round(n_pos.to(torch.float32) * (1.0 / cf.roi_positive_ratio - 1.0)).to(torch.int64)
    sel = ops.shem_select(shem_rand, fg, torch.where(any_gt, iou_max < 0.01, True) & prop_valid,
                          neg_count.clamp_min(1), n_neg_slots, cf.shem_poolsize)
    neg_idx, neg_valid = _lowest(torch.where(sel, neg_rand, float("inf")), n_neg_slots)

    def zeros(*s, dtype=torch.float32):
        return torch.zeros((bsz, n_neg_slots, *s), dtype=dtype, device=dev)

    return (torch.cat([pos_rois, torch.take_along_dim(proposals, neg_idx[..., None], dim=1)], dim=1),
            torch.cat([pos_valid, neg_valid], dim=1), torch.cat([cls_pos, zeros(dtype=torch.int32)], dim=1),
            torch.cat([deltas, zeros(6)], dim=1), torch.cat([masks, zeros(*shape)], dim=1),
            torch.cat([pos_valid, zeros(dtype=torch.bool)], dim=1),
            torch.cat([mask_pos, zeros(dtype=torch.bool)], dim=1))


class MaskRCNN:
    """3D Mask R-CNN: FPN, RPN, proposals, classify-all in chunks of
    ``roi_chunk_size`` RoIs, refinement, and the mask head in training."""

    def __init__(self, cf, device, remat=True):
        self.cf = cf
        self.device = torch.device(device)
        self.module = MRCNNModule(cf, remat).to(self.device)
        self.anchors = ops.generate_pyramid_anchors(cf).to(self.device, torch.float32)

    def classify(self, maps, rois):
        """Every proposal classified, element by element in chunks of
        ``roi_chunk_size``: (logits (R, C), deltas (R, C, 2d), flat rois,
        batch index)."""
        bsz, P = rois.shape[:2]
        flat = rois.reshape(-1, rois.shape[-1])
        bix = torch.arange(bsz, dtype=torch.int32, device=rois.device).repeat_interleave(P)
        chunk = self.cf.roi_chunk_size
        outs = [self.module.classifier(self.module.align(maps, flat[i:i + chunk], bix[i:i + chunk],
                                                         self.module.pool_size))
                for i in range(0, flat.shape[0], chunk)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]), flat, bix

    def candidates(self, flat_rois, probs, deltas, bix):
        """Every refinement candidate: each proposal for each foreground
        class, decoded, clipped and rounded, with its score (float32); only
        those at or above ``model_min_confidence``, as the refinement takes."""
        cf = self.cf
        R, C = probs.shape
        n_fg = C - 1
        scale, std, window = (_tensor(cf, n, self.device) for n in ("scale", "bbox_std_dev", "window"))
        scores = probs[:, 1:].reshape(-1)
        rois = flat_rois.repeat_interleave(n_fg, dim=0)
        boxes = ops.apply_box_deltas(rois, deltas[:, 1:, :].reshape(-1, 6) * std) * scale
        boxes = torch.round(ops.clip_boxes(boxes, window))
        ok = scores >= cf.model_min_confidence
        cls = torch.arange(1, C, device=self.device).repeat(R)
        return {"elem": bix.long().repeat_interleave(n_fg)[ok], "cls": cls[ok], "score": scores[ok],
                "box": boxes[ok]}

    def refine(self, cand, bsz):
        return refine(self.cf, cand, bsz)

    @torch.no_grad()
    def infer(self, img):
        """img -> (candidates, None): the refinement's candidates of the
        served proposals."""
        maps, rpn_logits, rpn_deltas = self.module.extract(img)
        rois, _ = proposal_layer(self.cf, self.anchors, ops.softmax(rpn_logits)[..., 1], rpn_deltas,
                                 self.cf.post_nms_rois_inference)
        logits, deltas, flat, bix = self.classify(maps, rois)
        return self.candidates(flat, ops.softmax(logits), deltas, bix), None

    def draws(self, generator, bsz):
        cf = self.cf
        A, P = self.anchors.shape[0], cf.post_nms_rois_training
        sizes = (A, min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A), P,
                 min(cf.shem_poolsize * roi_slots(cf)[1], P), P)
        return tuple(torch.rand((1, bsz, n), generator=generator, device=self.device)[0] for n in sizes)

    def loss(self, batch, draws):
        """The loss of one step: the RPN's class and box losses, then the
        classifier's, box and mask losses on the sampled RoIs."""
        cf = self.cf
        img, gt_boxes, gt_ids, gt_valid, gt_masks = batch
        match_rand, rpn_shem, pos_rand, roi_shem, neg_rand = draws
        scale = _tensor(cf, "scale", self.device)
        maps, rpn_logits, rpn_deltas = self.module.extract(img)
        rois, valid = proposal_layer(cf, self.anchors, ops.softmax(rpn_logits.detach())[..., 1], rpn_deltas.detach(),
                                     cf.post_nms_rois_training)
        with torch.no_grad():
            logits_all = self.classify(maps, rois)[0]
        std = _tensor(cf, "rpn_bbox_std_dev", self.device)
        match, tdeltas = ops.gt_anchor_matching(match_rand, self.anchors, gt_boxes, torch.ones_like(gt_ids), gt_valid,
                                                cf.anchor_matching_iou, 0.01, cf.rpn_train_anchors_per_image, std)
        rpn_cls, _ = ops.anchor_class_loss(rpn_shem, match, rpn_logits, cf.shem_poolsize,
                                           cf.rpn_train_anchors_per_image // 2)
        loss = rpn_cls.mean() + ops.anchor_bbox_loss(tdeltas, rpn_deltas, match).mean()
        bsz = img.shape[0]
        probs = ops.softmax(logits_all).reshape(bsz, -1, logits_all.shape[-1])
        s_rois, s_valid, s_cls, s_deltas, s_masks, s_pos, s_mpos = detection_targets(
            cf, (pos_rand, roi_shem, neg_rand), rois, valid, probs, gt_boxes / scale, gt_ids, gt_valid, gt_masks)
        flat = s_rois.reshape(-1, 6)
        bix = torch.arange(bsz, dtype=torch.int32, device=self.device).repeat_interleave(s_rois.shape[1])
        logits, bbox = self.module.classifier(self.module.align(maps, flat, bix, self.module.pool_size))
        cls, pos = s_cls.reshape(-1), s_pos.reshape(-1)
        loss = loss + _flat_mean(ops.softmax_ce(logits, cls.clamp_min(0)), s_valid.reshape(-1))
        rows = torch.arange(cls.shape[0], device=self.device)
        pick = cls.clamp(0, bbox.shape[1] - 1).long()
        per = ops.smooth_l1(bbox[rows, pick], s_deltas.reshape(-1, 6))
        loss = loss + _flat_mean(per, pos[:, None].expand_as(per))
        pred = self.module.mask(self.module.align(maps, flat, bix, self.module.mask_pool_size))[rows, pick]
        target = s_masks.reshape(-1, *cf.mask_shape)
        bce = -(target * torch.log(pred.clamp(1e-7, 1.0)) + (1 - target) * torch.log((1 - pred).clamp(1e-7, 1.0)))
        return loss + _flat_mean(bce, s_mpos.reshape(-1, 1, 1, 1).expand_as(bce))


def train_steps(model, batches, generator, lr, weight_decay, n_steps):
    """``n_steps`` Adam steps of ``model`` (one microbatch each) on
    ``batches``; the draws of each step from ``generator``. Returns (losses,
    first gradient per parameter name as Adam takes it, parameters after the
    last step)."""
    params = dict(model.module.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    losses, first_grad = [], None
    for batch in batches[:n_steps]:
        draws = model.draws(generator, batch[0].shape[0])
        opt.zero_grad(set_to_none=True)
        loss = model.loss(batch, draws)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if first_grad is None:
            first_grad = {k: (p.grad + weight_decay * p.detach()).clone() for k, p in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return losses, first_grad, {k: p.detach().clone() for k, p in params.items()}
