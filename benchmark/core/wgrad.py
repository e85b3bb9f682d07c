"""The weight gradients that the measured program's kernel K5 computes in a
training step, counted from the configuration's shapes: each conv of the
reference model's differentiated walk that K5's gate admits, and K5's least
time for them.

The walk is the one each model family's ``flops`` takes on the ``meta``
device (``reference/retina_unet.py``: the whole forward;
``reference/mrcnn.py``: the FPN and RPN, and the classifier and mask head
on the sampled RoIs; the classify-all pass runs without a gradient), with a
forward hook on every ``ConvND``. The gate's rule on a conv: 3D, a kernel
larger than 1 voxel, more than 2 input channels (the stem kernels K3 / K4
take the 1- and 2-channel stems), one group, no dilation, stride 1, padding
at most kernel - 1 on each axis, in a configuration whose precision is
float32 with TF32 off. It restates the program's gate
(``ops/conv_wgrad.py::admits``, which the benchmark may not import) with one
difference: "more than 2 input channels" stands for the program's "not taken
by K3 / K4", which admits the same convs in a configuration that sets
``MDT_STEM_PALLAS=1`` (the 1- and 2-channel stems go to K4) but not in one
that leaves it unset. A change of the gate leaves this rule stale without an
error (PERF.md §7).

K5's least time for one conv: the larger of x, dy and dw once at the
memory rate and 2 x its multiply-adds (those of the forward) at the float32
rate (``work.bound_s``); summed over the step's admitted convs.
"""

from __future__ import annotations

import math

import torch

from benchmark.core import work


def _walk(cf, family: str):
    """(module, forward) of a family's differentiated training walk on the
    ``meta`` device, or None for a family this file does not know."""
    from benchmark.reference.models import roi_slots

    if family == "retina_unet":
        from benchmark.reference.retina_unet import Module
    elif family == "mrcnn":
        from benchmark.reference.mrcnn import Module
    else:
        return None
    with torch.device("meta"):
        net = Module(cf, remat=False)
        img = torch.empty((cf.batch_size, cf.n_channels, *cf.patch_size))
        if family == "retina_unet":
            return net, lambda: net(img)
        n_rois = cf.batch_size * sum(roi_slots(cf))
        sampled = torch.empty((n_rois, cf.end_filts, *cf.pool_size))
        sampled_masks = torch.empty((n_rois, cf.end_filts, *cf.mask_pool_size))
    return net, lambda: (net.extract(img), net.classifier(sampled), net.mask(sampled_masks))


def admitted(conv, x_shape) -> bool:
    """The gate's rule on an ``nn.Conv3d`` applied to an input of
    ``x_shape``."""
    if not isinstance(conv, torch.nn.Conv3d) or conv.groups != 1 or tuple(conv.dilation) != (1, 1, 1):
        return False
    k, p = conv.kernel_size, conv.padding
    return (math.prod(k) > 1 and x_shape[1] > 2 and tuple(conv.stride) == (1, 1, 1)
            and all(0 <= pi <= ki - 1 for pi, ki in zip(p, k)))


def convs(cf, family: str):
    """([(x shape, w shape, dy shape, multiply-adds) of each admitted conv
    call of one training step], multiply-adds of every conv of the walk), or
    None for a family this file does not know."""
    from benchmark.reference.models import ConvND

    walk = _walk(cf, family)
    if walk is None:
        return None
    net, forward = walk
    rows, total = [], [0]

    def hook(m, inputs, out):
        w = m.conv.weight
        macs = out.numel() * w.shape[1] * math.prod(w.shape[2:])
        total[0] += macs
        if admitted(m.conv, inputs[0].shape):
            rows.append((tuple(inputs[0].shape), tuple(w.shape), tuple(out.shape), macs))

    hooks = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, ConvND)]
    try:
        forward()
    finally:
        for h in hooks:
            h.remove()
    return rows, total[0]


def k5_bound_s(cf, family: str, precision: dict):
    """K5's least time for one training step (s), or None where K5 does not
    run (another precision, or a family this file does not know)."""
    if precision.get("dtype") != "float32" or precision.get("tf32"):
        return None
    found = convs(cf, family)
    if found is None:
        return None
    return sum(work.bound_s((math.prod(x) + math.prod(dy) + math.prod(w)) * 4, 2.0 * macs)
               for x, w, dy, macs in found[0])
