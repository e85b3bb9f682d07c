"""RetinaNet / Retina U-Net, 2D + 3D (torch): inference and training.

Counterpart of ``medicaldetectiontoolkit_tpu/models/retina_net.py``:
  * ``DenseHead``: 4 conv3x3(+relu) -> conv3x3 with A*out channels, shared
    across pyramid levels, flattened in the anchor order of
    ``ops/anchors.py`` (positions (y, x, (z)) major, anchor minor);
  * ``RetinaModule``: FPN + class/box heads on P2.. (+ the P0 segmentation
    head of Retina U-Net); under spatial partitioning each level's head
    outputs are gathered along Y per level, before the flatten, so that the
    anchor order holds, and the seg logits stay on this rank's Y slab
    (``parallel/mesh.py``);
  * ``refine_detections``: batch-global exact top-``pre_nms_limit`` over
    foreground probabilities, delta decode, window clip, round, one NMS lane
    per (element, class) through the NMS dispatcher (the CUDA kernel for
    CUDA tensors), then a per-element top-k merge;
  * training (``retina_net.py:266-417``): anchor matching, SHEM, the CE and
    smooth-L1 anchor losses (+ dice and CE on the seg head), backward per
    microbatch, Adam, then detection refinement of the merged heads; under
    spatial partitioning all of it on the gathered heads, identically on
    every rank of the space group, and the seg loss and argmax on the slab
    of the logits and of the labels (``_seg_space``), the argmax joined in
    ``train_forward_convert`` / ``test_forward_convert`` only where seg_preds
    are asked for.

The random draws of a step (matching and SHEM) come from ``self.generator``,
a ``torch.Generator`` on the detector's device seeded from ``cf.seed``, and
reach the loss as tensors, so a test can feed JAX's own draws.
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
from medicaldetectiontoolkit_torch.ops import losses as loss_ops
from medicaldetectiontoolkit_torch.ops import matching as match_ops
from medicaldetectiontoolkit_torch.ops import nms as nms_ops
from medicaldetectiontoolkit_torch.ops.topk import top_k
from medicaldetectiontoolkit_torch.parallel import mesh
from medicaldetectiontoolkit_torch.utils import trace


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
        x = mesh.gather_y(self.final(self.convs(x)))  # a Y slab's rows joined: the identity on one process
        # channel-last flatten: rows in (y, x, (z), anchor) order
        return x.movedim(1, -1).reshape(x.shape[0], -1, self.out_per_anchor)


class RetinaModule(nn.Module):
    """FPN + shared dense heads (+ optional P0 segmentation head)
    (``retina_net.py:76-139``)."""

    def __init__(self, dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                 operate_stride1, head_classes, n_rpn_features, n_anchors_per_pos, anchor_stride,
                 pyramid_levels: Sequence[int], num_seg_classes=0, dtype=torch.float32, remat=False):
        super().__init__()
        self.dtype = dtype
        self.pyramid_levels = tuple(pyramid_levels)
        # P0 is prepended with operate_stride1; detection heads read P2..
        self.level_offset = 1 if operate_stride1 else 0
        self.fpn = FPN(dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                       operate_stride1, dtype=dtype, remat=remat)
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
        slabs = self.fpn.slab_levels
        seg_logits = None
        if self.seg_head is not None:
            with mesh.on_slabs(slabs[0]):
                seg_logits = self.seg_head(fpn_outs[0])  # this rank's Y slab where P0 is split
        heads = [], []
        for i in self.pyramid_levels:
            with mesh.on_slabs(slabs[i + self.level_offset]):
                for out, head in zip(heads, (self.cls_head, self.box_head)):
                    out.append(head(fpn_outs[i + self.level_offset]))
        class_logits, bb_deltas = (torch.cat(out, dim=1).float() for out in heads)
        return class_logits, bb_deltas, seg_logits


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
    dp = mesh.current()
    k = min(cf.pre_nms_limit, bsz * (1 if dp is None else dp.world) * A * n_fg)

    flat = loss_ops.softmax(class_logits)[..., 1:].reshape(-1)
    # exact top-k: flat index order is (elem, anchor, class), so an
    # approximate selection would drop the weaker class of the same anchor;
    # in a data-parallel step the selection spans the global batch, and
    # ``own`` marks the candidates of this rank's rows
    scores, flat_ix, own = mesh.batch_top_k(flat, k, A * n_fg)
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
    trace.count("k1.lanes", n_lanes)
    trace.count("k1.candidates", n_lanes * k)
    lane_elem = torch.arange(bsz, device=dev).repeat_interleave(n_fg)
    lane_class = torch.arange(1, C, device=dev).repeat(bsz)
    lane_valid = (cand_elem[None, :] == lane_elem[:, None]) & (cand_class[None, :] == lane_class[:, None])
    if own is not None:
        lane_valid &= own[None, :]
    lane_idx, lane_mask = nms_fn(
        boxes.expand(n_lanes, k, boxes.shape[-1]), scores.expand(n_lanes, k),
        cf.detection_nms_threshold, max_inst, valid=lane_valid,
    )
    lane_idx = lane_idx.reshape(bsz, n_fg * max_inst).long()
    lane_mask = lane_mask.reshape(bsz, n_fg * max_inst)

    merged_scores = torch.where(lane_mask, scores[lane_idx.clamp(0, k - 1)], float("-inf"))
    _, top_pos = top_k(merged_scores, max_inst, dim=1)
    final_idx = torch.take_along_dim(lane_idx, top_pos, dim=1).clamp(0, k - 1)
    final_mask = torch.take_along_dim(lane_mask, top_pos, dim=1)

    det = torch.cat(
        [boxes[final_idx], cand_class[final_idx][..., None].to(torch.float32), scores[final_idx][..., None]],
        dim=-1,
    )
    return det, final_mask


@register("retina_net")
class RetinaNetDetector(base.Detector):
    """Host-facing RetinaNet with the reference's train/test_forward API."""

    with_seg_head = False
    # the NMS kernel's entry point: the device-keyed dispatcher; a check
    # swaps in another (the plain version, or one that records its calls)
    nms_fn = staticmethod(nms_ops.batched_nms_auto)

    def build(self):
        cf = self.cf
        h, w = cf.patch_size[:2]
        if h % 2**5 or w % 2**5:
            raise ValueError("patch size must be divisible by 2**5 (e.g. 256, 320, 384, ...)")
        self.anchors = anchor_ops.generate_pyramid_anchors(cf, self.logger).to(self.device, torch.float32)
        self.np_anchors = self.anchors.cpu().numpy()
        self.bbox_std = base.host_to_device(np.asarray(cf.rpn_bbox_std_dev), self.device)
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
            remat=base.resolve_remat(cf),
        ).to(self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(cf.seed)

    def init_params(self, seed: int = 0):
        init_weights(self.module, self.cf.weight_init, torch.Generator().manual_seed(seed))

    # ---- inference ------------------------------------------------------
    def _predict(self, img):
        return self._spatial(self.module, img)

    def _finalize_outputs(self, class_logits, bb_deltas, seg_logits):
        with trace.span("refine", device=self.device):
            det, det_mask = refine_detections(self.anchors, class_logits, bb_deltas, self.cf, nms_fn=self.nms_fn)
        seg_preds = None
        if seg_logits is not None:  # (b, 1, *spatial); a Y slab under spatial partitioning
            seg_preds = torch.argmax(seg_logits, dim=1, keepdim=True).to(torch.uint8)
        return det, det_mask, seg_preds

    # ---- training -------------------------------------------------------
    def _prep(self, batch):
        """Upload one batch: image, padded GTs and (Retina U-Net) seg labels,
        this rank's Y slab of them under spatial partitioning."""
        cf, dev = self.cf, self.device
        img = base.host_to_device(batch["data"], dev)
        gt = base.pad_gt_boxes(batch["bb_target"], batch["roi_labels"], img.shape[0], cf.dim, cf.max_gt_boxes, dev)
        seg = None
        if self.with_seg_head:
            labels = batch["seg"] if "seg" in batch else np.zeros((img.shape[0], 1, *img.shape[2:]), np.int32)
            seg = base.host_to_device(self._seg_slab(labels), dev, np.int32)
        return (img, *gt, seg)

    def draws(self, n_micro: int, m: int):
        """One step's uniform draws from ``self.generator``, per microbatch:
        matching (n_micro, m, A) and SHEM (n_micro, m, k_pool)."""
        cf = self.cf
        A = self.anchors.shape[0]
        k_pool = min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A)
        kw = dict(generator=self.generator, device=self.device)
        return torch.rand((n_micro, m, A), **kw), torch.rand((n_micro, m, k_pool), **kw)

    def _losses_and_outputs(self, img, gt_boxes, gt_ids, gt_valid, seg, match_rand, shem_rand):
        """Loss and aux of one microbatch (``retina_net.py:266-308``); the
        draws are (m, A) for matching and (m, k_pool) for SHEM."""
        cf = self.cf
        class_logits, bb_deltas, seg_logits = self._spatial_train(self.module, img)  # heads gathered along Y
        neg_iou = 0.1 if cf.dim == 2 else 0.01
        with trace.span("losses", device=self.device):
            matches, tdeltas = match_ops.gt_anchor_matching(
                match_rand, self.anchors, gt_boxes, gt_ids, gt_valid, cf.anchor_matching_iou, neg_iou,
                cf.rpn_train_anchors_per_image, self.bbox_std)
            class_losses, neg_sel = loss_ops.anchor_class_loss(
                shem_rand, matches, class_logits, cf.shem_poolsize, cf.rpn_train_anchors_per_image // 2)
            class_loss = mesh.batch_mean(class_losses)
            bbox_loss = mesh.batch_mean(loss_ops.anchor_bbox_loss(tdeltas, bb_deltas, matches))
            loss = class_loss + bbox_loss
            monitor = {"class_loss": class_loss, "bbox_loss": bbox_loss}
            if seg_logits is not None:
                seg_dice, seg_ce = loss_ops.fused_seg_loss(seg_logits, seg, cf.num_seg_classes,
                                                           space=self._seg_space(img.shape[2]))
                loss = loss + (seg_dice + seg_ce) / 2.0
                monitor.update({"seg_dice_loss": seg_dice, "seg_ce_loss": seg_ce})
            monitor["loss"] = loss
            max_half = max(cf.rpn_train_anchors_per_image // 2, 1)
            aux = {
                "heads": tuple(None if h is None else h.detach() for h in (class_logits, bb_deltas, seg_logits)),
                "anchor_info": base.compact_anchor_indices(matches, neg_sel, max_half, max_half),
                "monitor": {k: v.detach() for k, v in monitor.items()},
            }
        return loss, aux

    def _accumulate(self, inputs, draws):
        """Loss and gradients of one step: ``draws`` is ``self.draws``' pair,
        one row per microbatch; grads land in the params' ``.grad``
        (``retina_net.py:317-331``). Returns (mean loss, merged aux)."""
        match_rand, shem_rand = draws
        n_micro = match_rand.shape[0]
        m = inputs[0].shape[0] // n_micro

        def micro(i):
            part = [None if t is None else t[i * m:(i + 1) * m] for t in inputs]
            return self._losses_and_outputs(*part, match_rand[i], shem_rand[i])

        loss, auxs = base.accum_backward(list(self.module.parameters()), micro, n_micro)
        return loss, base.merge_microbatch_aux(auxs)

    def train_forward_dispatch(self, batch, is_validation: bool = False, do_update: bool = True):
        """Enqueue one step (the update unless validating), the detection
        refinement of its heads and the host copies of its small results
        (monitor values, sampled anchors, detections); return handles that
        nothing has waited for yet."""
        validating = is_validation or not do_update
        rid = trace.request()
        with trace.span("dispatch", rid=rid, kind="val" if validating else "train"):
            with trace.span("upload"):
                inputs = self._prep(batch)
            n_micro, m = self.step_layout(inputs[0].shape[0], 1 if validating else None)
            draws = self.step_draws(n_micro, m)
            with self.data_parallel_step(n_micro):
                if validating:
                    with torch.no_grad():
                        _, aux = self._losses_and_outputs(*inputs, *(d[0] for d in draws))
                else:
                    _, aux = self._accumulate(inputs, draws)
                    self._update()
                with torch.no_grad():
                    det, det_mask, seg_preds = self._finalize_outputs(*aux["heads"])
            keys = list(aux["monitor"])
            host, copied = base.start_host_copies([*aux["monitor"].values(), *aux["anchor_info"], det, det_mask])
        return base.Handles(rid, (tuple(inputs[0].shape), dict(zip(keys, host)), host[len(keys):-2], host[-2],
                                  host[-1], seg_preds, copied))

    def train_forward_convert(self, handles, batch, need_seg_preds: bool = True):
        """One step's handles -> the reference results dict
        (``retina_net.py:386-417``), waiting for that step's host copies."""
        cf = self.cf
        img_shape, monitor, anchor_info, det, det_mask, seg_preds, copied = handles
        with base.convert_span(handles):
            base.wait_for(copied, "host copies")
            with trace.span("assemble"):
                boxes = [[] for _ in range(img_shape[0])]
                base.add_gt_boxes_to_results(batch, boxes)
                base.add_anchor_boxes_to_results(self.np_anchors, [t.numpy() for t in anchor_info], img_shape[2:],
                                                  boxes)
                base.detections_to_box_results(cf, det.numpy(), det_mask.numpy(), boxes)
                # need_seg_preds=False skips the full-volume copy
                seg = self._make_seg_preds(det, det_mask, None, seg_preds if need_seg_preds else None,
                                           batch["data"].shape, True)
        monitor = {k: float(v) for k, v in monitor.items()}
        logger_string = "loss: {0:.2f}, class: {1:.2f}, bbox: {2:.2f}".format(
            monitor["loss"], monitor["class_loss"], monitor["bbox_loss"])
        if "seg_dice_loss" in monitor:
            logger_string += ", seg dice: {0:.3f}, seg ce: {1:.3f}".format(
                monitor["seg_dice_loss"], monitor["seg_ce_loss"])
        return {
            "boxes": boxes,
            "seg_preds": seg,
            "loss": monitor["loss"],
            "torch_loss": monitor["loss"],  # legacy key some callers expect
            "monitor_values": {"loss": monitor["loss"], "class_loss": monitor["class_loss"]},
            "logger_string": logger_string,
        }


@register("retina_unet")
class RetinaUNetDetector(RetinaNetDetector):
    """Retina U-Net: RetinaNet + operate_stride1 FPN + P0 segmentation head."""

    with_seg_head = True
