"""The 3D Retina U-Net family, as a configuration's ``model`` names it:
what the harness needs of a model family, found by that name.

``Module`` (the parameters' names and shapes), ``Detector`` (the plain
reference detector), ``WITH_MASKS`` (whether a training batch carries the
GT masks), ``flops`` (one request's FLOPs, ``core/work.py``) and
``k1_bound_s`` (the NMS kernel's least time per served chunk)."""

from __future__ import annotations

import torch

from benchmark.core import work
from benchmark.reference.models import RetinaModule as Module
from benchmark.reference.models import RetinaUNet as Detector

__all__ = ["Module", "Detector", "WITH_MASKS", "flops", "k1_bound_s"]

WITH_MASKS = False


def flops(cf, train: bool) -> float:
    """FLOPs of a training step (3 x the forward) or of a served chunk of
    ``cf.batch_size`` patches."""
    with torch.device("meta"):
        net = Module(cf, remat=False)
        img = torch.empty((cf.batch_size, cf.n_channels, *cf.patch_size))
    return 2.0 * work.macs(net, lambda: net(img)) * (3 if train else 1)


def k1_bound_s(cf) -> float:
    """The refinement's NMS over every (element, class) lane of the batch's
    top ``pre_nms_limit`` candidates, broadcast to the lanes."""
    b, n_fg, max_inst = cf.batch_size, cf.head_classes - 1, cf.model_max_instances_per_batch_element
    k = min(cf.pre_nms_limit, b * work.n_anchors(cf) * n_fg)
    return work.nms_bound_s(b * n_fg, k, max_inst, True, True)
