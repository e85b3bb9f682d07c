"""The 3D Mask R-CNN family, as a configuration's ``model`` names it: what
the harness needs of a model family, found by that name (the names as in
``reference/retina_unet.py``)."""

from __future__ import annotations

import torch

from benchmark.core import work
from benchmark.reference.models import MaskRCNN as Detector
from benchmark.reference.models import MRCNNModule as Module
from benchmark.reference.models import roi_slots

__all__ = ["Module", "Detector", "WITH_MASKS", "flops", "k1_bound_s"]

WITH_MASKS = True


def flops(cf, train: bool) -> float:
    """FLOPs of a served chunk: the FPN and RPN, and the classifier on every
    proposal. Of a training step: 3 x the FPN, RPN and the sampled RoIs'
    classifier and mask head, and once the classify-all pass on the
    training proposals, which runs without a gradient."""
    C = cf.end_filts
    with torch.device("meta"):
        net = Module(cf, remat=False)
        img = torch.empty((cf.batch_size, cf.n_channels, *cf.patch_size))
        n_rois = cf.batch_size * sum(roi_slots(cf))
        served = torch.empty((cf.batch_size * cf.post_nms_rois_inference, C, *cf.pool_size))
        sampled = torch.empty((n_rois, C, *cf.pool_size))
        sampled_masks = torch.empty((n_rois, C, *cf.mask_pool_size))
        proposals = torch.empty((cf.batch_size * cf.post_nms_rois_training, C, *cf.pool_size))
    extract = work.macs(net, lambda: net.extract(img))
    if not train:
        return 2.0 * (extract + work.macs(net, lambda: net.classifier(served)))
    grad_part = extract + work.macs(net, lambda: (net.classifier(sampled), net.mask(sampled_masks)))
    return 2.0 * (3 * grad_part + work.macs(net, lambda: net.classifier(proposals)))


def k1_bound_s(cf) -> float:
    """The proposal layer's NMS per element, and the refinement's over every
    (element, class) lane of the classified proposals."""
    b, n_fg, max_inst = cf.batch_size, cf.head_classes - 1, cf.model_max_instances_per_batch_element
    proposals = work.nms_bound_s(b, min(cf.pre_nms_limit, work.n_anchors(cf)), cf.post_nms_rois_inference,
                                 False, False)
    refine = work.nms_bound_s(b * n_fg, b * cf.post_nms_rois_inference * n_fg, max_inst, True, True)
    return proposals + refine
