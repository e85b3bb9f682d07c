"""The work a cell asks of the card, counted from the configuration's
shapes, whatever implements it: the model's FLOPs per request, each
hand-written kernel's least time per request, and the card's peaks.

FLOPs are 2 x the multiply-adds of every conv, transposed conv and linear
layer of the reference model at the configuration's widths and the cell's
shapes, counted once on the ``meta`` device by each model family's own walk
(``reference/<model>.py``'s ``flops``). A training step counts 3 x the
forward of what it differentiates (forward, and the backward's two products
per layer), and once what runs without a gradient (Mask R-CNN's classify-all
pass); remat's recomputation is not counted.

A kernel's least time is the larger of its bytes over the memory rate and
its operations over the peak rate (the formulas of the measured package's
``tools/time_*.py``): each input byte read once, each output byte written
once, and only the work its inputs need. Where that work depends on the data
(the IoU tests NMS makes, the map voxels RoIAlign touches) only the part the
shapes fix is counted, so the bound stays a bound.
"""

from __future__ import annotations

import math

import torch.nn as nn

# the H100's published peaks (NVIDIA's data sheet, SXM, dense): memory rate,
# and arithmetic outside the tensor cores for float32 (the roof with TF32
# off) and of the tensor cores for bfloat16
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# one IoU test in 3D: 9 operations per axis, 6 for the union, the division
# and the comparison (``tools/time_nms.py``)
OPS_PER_IOU = 9 * 3 + 6


def bound_s(bytes_moved: float, ops: float, dtype: str = "float32") -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


class _MacCounter:
    """Forward hooks that add up the multiply-adds of every conv and linear
    layer of a module."""

    def __init__(self, module, conv_types):
        self.macs = 0
        self.hooks = [m.register_forward_hook(self._hook) for m in module.modules()
                      if isinstance(m, conv_types + (nn.ConvTranspose3d, nn.Linear))]

    def _hook(self, m, inputs, out):
        if isinstance(m, nn.Linear):
            self.macs += out.numel() * m.in_features
        elif isinstance(m, nn.ConvTranspose3d):
            self.macs += inputs[0].numel() * m.weight.shape[1] * math.prod(m.kernel_size)
        else:
            w = m.conv.weight
            self.macs += out.numel() * w.shape[1] * math.prod(w.shape[2:])

    def close(self):
        for h in self.hooks:
            h.remove()


def macs(module, forward) -> int:
    """The multiply-adds of every conv and linear layer of ``module`` that
    ``forward()`` runs."""
    from benchmark.reference.models import ConvND

    counter = _MacCounter(module, (ConvND,))
    try:
        forward()
    finally:
        counter.close()
    return counter.macs


def _stem(cf):
    """(cin, k, y stride, output voxels) of the FPN's first conv, the one
    the stem kernels K3 and K4 run: conv0 (k 3) with the stride-1 levels,
    C1 (k 7, stride (2, 2, 1)) without."""
    b, (y, x, z) = cf.batch_size, cf.patch_size
    if cf.operate_stride1:
        return cf.n_channels, 3, 1, b * cf.start_filts * y * x * z
    return cf.n_channels, 7, 2, b * cf.start_filts * -(-y // 2) * -(-x // 2) * z


def k3_bound_s(cf) -> float:
    """K3, the stem conv's forward, per launch: x, w and b read, the output
    written; 2 operations per multiply-add."""
    cin, k, _, n_out = _stem(cf)
    n_in = cf.batch_size * cin * math.prod(cf.patch_size)
    n_w = cf.start_filts * cin * k ** 3
    return bound_s((n_in + n_w + cf.start_filts + n_out) * 4, 2.0 * n_out * cin * k ** 3)


def k4_bound_s(cf) -> float:
    """K4, the stem conv's weight gradient, per launch: x and the output's
    gradient read, dw written; 2 operations per multiply-add."""
    cin, k, _, n_out = _stem(cf)
    n_in = cf.batch_size * cin * math.prod(cf.patch_size)
    return bound_s((n_in + n_out + cf.start_filts * cin * k ** 3) * 4, 2.0 * n_out * cin * k ** 3)


def nms_bound_s(lanes, n, max_out, broadcast: bool, valid: bool) -> float:
    """One NMS launch over ``lanes`` lanes of ``n`` candidates: boxes and
    scores read once (once for all lanes where broadcast), the valid flags,
    the keep lists written; a compare per entry and the IoU tests among the
    kept boxes."""
    reads = n * (6 + 1) * 4 * (1 if broadcast else lanes) + (lanes * n if valid else 0)
    ops = lanes * n + lanes * max_out * (max_out - 1) // 2 * OPS_PER_IOU
    return bound_s(reads + lanes * max_out * 5, ops)


def n_anchors(cf) -> int:
    per_pos = cf.n_anchors_per_pos
    return sum(math.prod(s) for s in (cf.backbone_shapes[lvl] for lvl in cf.pyramid_levels)) * per_pos
