"""Detection U-Net (torch): semantic segmentation and boxes from connected
components.

Counterpart of ``medicaldetectiontoolkit_tpu/models/detection_unet.py``:
  * ``SegUNetModule``: the FPN with ``operate_stride1`` and a 1x1 float32
    segmentation head on P0, trained with dice, weighted CE or both
    (``cf.seg_loss_mode``, ``ops/losses.py::fused_seg_loss``);
  * detections without parameters (``get_coords``, ``_boxes_from_softmax``):
    per foreground class, the voxels whose softmax argmax is that class are
    split into connected components on the host (``scipy.ndimage.label``),
    the ``cf.n_roi_candidates`` largest are boxed, and each is scored by the
    max (or median) softmax of the class inside it.

Under spatial partitioning (``parallel/mesh.py``) the test, train and
validation forwards run on this rank's Y slab (the seg head's GroupNorm sums
over the space group), and so do the seg loss (its sums added over the
group, ``fused_seg_loss``'s ``space``) and the softmax, which is then joined
along Y detached (``SpaceGroup.gather_y``: the bytes of the logits, no
backward), since the host scores each component by the whole softmax. Every
rank of a space group then makes the host convert of the same softmax
(argmax, components, boxes); the writer's results are the ones exec
evaluates.

The softmax stays channel-first ``(b, C, *spatial)`` on both sides of the
device->host copy, which every train step, validation step and test chunk
queues at dispatch (``base.start_host_copies``). Gradient accumulation
averages the losses and gradients of the microbatches, and the batch dice is
computed per microbatch, as in JAX (``base.py:209-230``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from medicaldetectiontoolkit_torch.models import base, register
from medicaldetectiontoolkit_torch.models.backbone import FPN, ConvND, init_weights
from medicaldetectiontoolkit_torch.ops import losses as loss_ops
from medicaldetectiontoolkit_torch.parallel import mesh
from medicaldetectiontoolkit_torch.utils import trace


class SegUNetModule(nn.Module):
    """FPN with stride-1 levels + 1x1 seg head to ``num_seg_classes``
    (``detection_unet.py:31-66``). The head runs in float32 whatever the
    compute dtype."""

    def __init__(self, dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                 num_seg_classes, dtype=torch.float32, remat=False):
        super().__init__()
        self.dtype = dtype
        self.fpn = FPN(dim, n_channels, start_filts, end_filts, res_architecture, norm, relu, sixth_pooling,
                       operate_stride1=True, dtype=dtype, remat=remat)
        self.seg_head = ConvND(dim, end_filts, num_seg_classes, ks=1, relu=None, norm=norm, dtype=torch.float32)

    def forward(self, img):
        p0 = self.fpn(img.to(self.dtype))[0]
        with mesh.on_slabs(self.fpn.slab_levels[0]):
            return self.seg_head(p0)  # (b, C, *spatial) float32 logits; this rank's Y slab where P0 is split


def channel_softmax(logits):
    """Softmax over the channel axis 1, in ``jax.nn.softmax``'s operation
    order: ``exp(x - max) / sum``."""
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def get_coords(binary_mask, n_components, dim):
    """Boxes around the ``n_components`` largest connected components of
    each batch element (``detection_unet.py:69-109``).

    binary_mask (b, y, x[, z]). Components come from ``ndimage.label`` with
    its default connectivity and are ranked by ``np.argsort(sizes)[::-1]``;
    in-plane coords are ``[start - 1, stop]`` and z ``[start, stop]``, all
    clipped at 0, the in-plane ones to ``shape[-2]`` (in 2D that is y's
    extent for all four) and z to ``shape[-1]``.

    Returns (per element a coords array, or ``[]`` without components; per
    element a list of (bbox slices, in-bbox boolean mask) per component).
    """
    from scipy import ndimage

    binary_mask = binary_mask.astype("uint8")
    in_plane_cap = binary_mask.shape[-2]
    z_cap = binary_mask.shape[-1]
    batch_coords, batch_components = [], []
    for element in binary_mask:
        labeled, n_found = ndimage.label(element)
        object_slices = ndimage.find_objects(labeled)
        sizes = np.bincount(labeled.ravel())[1:]
        largest = np.argsort(sizes)[::-1][:n_components] + 1 if n_found else []
        coords, components = [], []
        for lab in largest:
            sl = object_slices[lab - 1]
            box = [sl[0].start - 1, sl[1].start - 1, sl[0].stop, sl[1].stop]
            if dim == 3:
                box += [sl[2].start, sl[2].stop]
            coords.append(box)
            components.append((sl, labeled[sl] == lab))
        if coords:
            coords = np.array(coords)
            np.clip(coords, 0, None, out=coords)
            coords[:, :4] = np.minimum(coords[:, :4], in_plane_cap)
            if dim == 3:
                coords[:, 4:] = np.minimum(coords[:, 4:], z_cap)
        batch_coords.append(coords)
        batch_components.append(components)
    return batch_coords, batch_components


@register("detection_unet")
class DetectionUNetDetector(base.Detector):
    """Host-facing Detection U-Net with the reference's train/test_forward API."""

    def build(self):
        cf = self.cf
        self.module = SegUNetModule(
            dim=cf.dim,
            n_channels=cf.n_channels,
            start_filts=cf.start_filts,
            end_filts=cf.end_filts,
            res_architecture=cf.res_architecture,
            norm=cf.norm,
            relu=cf.relu,
            sixth_pooling=cf.sixth_pooling,
            num_seg_classes=cf.num_seg_classes,
            dtype=torch.bfloat16 if cf.compute_dtype == "bfloat16" else torch.float32,
            remat=base.resolve_remat(cf),
        ).to(self.device).eval()

    def init_params(self, seed: int = 0):
        init_weights(self.module, self.cf.weight_init, torch.Generator().manual_seed(seed))

    # ---- device ---------------------------------------------------------
    def _seg_loss(self, seg_logits, seg, space=None):
        """dice, weighted CE or their sum (``detection_unet.py:152-165``);
        ``space`` as ``fused_seg_loss``'s."""
        cf = self.cf
        dice, ce = loss_ops.fused_seg_loss(seg_logits, seg, cf.num_seg_classes,
                                           false_positive_weight=float(cf.fp_dice_weight),
                                           class_weights=cf.wce_weights, space=space)
        loss = torch.zeros((), dtype=torch.float32, device=seg_logits.device)
        if cf.seg_loss_mode in ("dice", "dice_wce"):
            loss = loss + dice
        if cf.seg_loss_mode in ("wce", "dice_wce"):
            loss = loss + ce
        return loss

    def _losses(self, img, seg):
        """(loss, detached softmax, whole along Y) of one (micro)batch."""
        seg_logits = self._spatial_train(self.module, img)  # this rank's Y slab under spatial partitioning
        with trace.span("losses", device=self.device):
            loss = self._seg_loss(seg_logits, seg, self._seg_space(img.shape[2]))
        return loss, self._seg_whole(channel_softmax(seg_logits.detach()), img.shape[2])

    def _prep(self, batch):
        """The image and the seg labels (this rank's Y slab of them under
        spatial partitioning)."""
        return (base.host_to_device(batch["data"], self.device),
                base.host_to_device(self._seg_slab(batch["seg"]), self.device, np.int32))

    def _accumulate(self, img, seg):
        """Loss and gradients of one step over ``cf.grad_accum_steps``
        microbatches (of the global batch in a data-parallel run); grads
        land in the params' ``.grad``. Returns (mean loss, softmax of the
        whole batch)."""
        n_micro = self.step_layout(img.shape[0])[0]
        m = img.shape[0] // n_micro
        loss, smax = base.accum_backward(list(self.module.parameters()),
                                         lambda i: self._losses(img[i * m:(i + 1) * m], seg[i * m:(i + 1) * m]),
                                         n_micro)
        return loss, torch.cat(smax)

    # ---- host heuristics ------------------------------------------------
    def _boxes_from_softmax(self, smax):
        """smax (b, C, *spatial) numpy -> per element the det box dicts
        (``detection_unet.py:193-215``)."""
        cf = self.cf
        argmaxed = np.argmax(smax, axis=1)
        box_results_list = [[] for _ in range(smax.shape[0])]
        for cl in range(1, len(cf.class_dict.keys()) + 1):
            box_coords, rois = get_coords((argmaxed == cl).astype("uint8"), cf.n_roi_candidates, cf.dim)
            for bix, broi in enumerate(rois):
                for nix, (nsl, nroi) in enumerate(broi):
                    vals = smax[bix, cl][nsl][nroi]
                    score = float(np.max(vals)) if cf.aggregation_operation == "max" else float(np.median(vals))
                    if score > cf.detection_min_confidence:
                        box_results_list[bix].append({
                            "box_coords": np.copy(box_coords[bix][nix]),
                            "box_score": score,
                            "box_pred_class_id": cl,
                            "box_type": "det",
                        })
        trace.count("detections", sum(map(len, box_results_list)))
        return box_results_list

    # ---- host API -------------------------------------------------------
    def train_forward_dispatch(self, batch, is_validation: bool = False, do_update: bool = True):
        """Enqueue one step (the update unless validating) and the host
        copies of its loss and softmax; return handles nothing has waited
        for yet."""
        validating = is_validation or not do_update
        rid = trace.request()
        with trace.span("dispatch", rid=rid, kind="val" if validating else "train"):
            with trace.span("upload"):
                img, seg = self._prep(batch)
            with self.data_parallel_step(self.step_layout(img.shape[0], 1 if validating else None)[0]):
                if validating:
                    with torch.no_grad():
                        loss, smax = self._losses(img, seg)
                else:
                    loss, smax = self._accumulate(img, seg)
                    self._update()
            host, copied = base.start_host_copies([loss.detach(), smax])
        return base.Handles(rid, (host[0], host[1], copied))

    def train_forward_convert(self, handles, batch, need_seg_preds: bool = True):
        """One step's handles -> the reference results dict. The boxes
        derive from the softmax volume, so it is read whatever
        ``need_seg_preds`` says."""
        loss, smax, copied = handles
        with base.convert_span(handles):
            base.wait_for(copied, "host copies")
            with trace.span("assemble"):
                smax = smax.numpy()
                boxes = self._boxes_from_softmax(smax)
                base.add_gt_boxes_to_results(batch, boxes)
                seg = np.argmax(smax, axis=1)[:, None].astype("uint8")
        loss = float(loss)
        return {
            "boxes": boxes,
            "seg_preds": seg,
            "loss": loss,
            "torch_loss": loss,
            "monitor_values": {"loss": loss},
            "logger_string": f"loss: {loss:.2f}",
        }

    def test_forward_dispatch(self, batch, **kwargs):
        """Enqueue the forward, its softmax (joined along Y under spatial
        partitioning) and the softmax's host copy."""
        rid = trace.request()
        with trace.span("dispatch", rid=rid, kind="test"), torch.inference_mode():
            with trace.span("upload"):
                img = base.host_to_device(batch["data"], self.device)
            smax = self._seg_whole(channel_softmax(self._spatial(self.module, img)), img.shape[2])
            host, copied = base.start_host_copies([smax])
        return base.Handles(rid, (host[0], copied))

    def test_forward_convert(self, handles, batch, **kwargs):
        smax, copied = handles
        with base.convert_span(handles):
            base.wait_for(copied, "host copies")
            with trace.span("assemble"):
                smax = smax.numpy()
                return {"boxes": self._boxes_from_softmax(smax),
                        "seg_preds": np.argmax(smax, axis=1)[:, None].astype("uint8")}
