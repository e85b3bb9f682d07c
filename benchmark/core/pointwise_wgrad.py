"""The weight gradients that the measured program's kernel K6 computes in a
training step, counted from the configuration's shapes: each stride-1 1x1x1
3D conv of the reference model's differentiated walk (``core/wgrad.py``'s
``_walk``, the one K5's bound takes), and K6's least time for them.

The rule on a conv: 3D, a 1x1x1 kernel, one group, no dilation, stride 1,
no padding, in a configuration whose precision is float32 with TF32 off. It
restates the program's gate (``ops/conv_wgrad.py::admits`` for a 1x1x1
kernel, which the benchmark may not import); the strided 1x1x1 shortcuts
keep cuDNN there and are left out here.

K6's least time for one conv: the larger of x, dy and dw once at the memory
rate and 2 x its multiply-adds at the float32 rate (``work.bound_s``);
summed over the step's admitted convs.
"""

from __future__ import annotations

import math

import torch

from benchmark.core import work
from benchmark.core.wgrad import _walk


def admitted(conv, x_shape) -> bool:
    """The gate's rule on an ``nn.Conv3d`` applied to an input of
    ``x_shape``."""
    return (isinstance(conv, torch.nn.Conv3d) and len(x_shape) == 5 and conv.groups == 1
            and math.prod(conv.kernel_size) == 1 and tuple(conv.stride) == (1, 1, 1)
            and tuple(conv.dilation) == (1, 1, 1) and tuple(conv.padding) == (0, 0, 0))


def convs(cf, family: str):
    """[(x shape, w shape, dy shape, multiply-adds) of each admitted conv
    call of one training step], or None for a family the walk does not
    know."""
    from benchmark.reference.models import ConvND

    walk = _walk(cf, family)
    if walk is None:
        return None
    net, forward = walk
    rows = []

    def hook(m, inputs, out):
        if admitted(m.conv, inputs[0].shape):
            w = m.conv.weight
            rows.append((tuple(inputs[0].shape), tuple(w.shape), tuple(out.shape), out.numel() * w.shape[1]))

    hooks = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, ConvND)]
    try:
        forward()
    finally:
        for h in hooks:
            h.remove()
    return rows


def k6_bound_s(cf, family: str, precision: dict):
    """K6's least time for one training step (s), or None where K6 does not
    run (another precision, or a family the walk does not know)."""
    if precision.get("dtype") != "float32" or precision.get("tf32"):
        return None
    found = convs(cf, family)
    if found is None:
        return None
    return sum(work.bound_s((math.prod(x) + math.prod(dy) + math.prod(w)) * 4, 2.0 * macs) for x, w, dy, macs in found)
