"""The weight gradient of the FPN's and heads' 3D convs (torch): the plain
version of kernel K5, its device-keyed dispatcher, the autograd function
that takes dw from K5 or K6, and the gate that decides which convs take
them.

K5 replaces no TPU kernel (the JAX package leaves these convs to XLA). It
takes cuDNN's place for the float32 weight gradient of a 3D conv whose
kernel is larger than 1, where cuDNN's float32 wgrads ran at about 2.5
TFLOP/s (PERF.md). The stride-1 1x1x1 convs take K6 instead
(``ops/pointwise_wgrad.py``): the path is chosen by the kernel's shape. The
forward stays ``F.conv3d`` and the input gradient cuDNN's.

Tensors are channel-first, as the port's convs take them: x ``(B, cin, Y,
X, Z)``, dy ``(B, cout, Yo, Xo, Zo)``, dw ``(cout, cin, ky, kx, kz)``.
CPU tensors take the plain version; CUDA tensors launch the kernel of
``ops/conv_wgrad_cuda.py`` (``csrc/conv_wgrad.cu``) or raise. There is no
third path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from medicaldetectiontoolkit_torch.ops import pointwise_wgrad
from medicaldetectiontoolkit_torch.utils import trace


def on_card(t) -> bool:
    return t.device.type == "cuda"


def admits(x, w, stride, padding, dilation=(1, 1, 1), groups: int = 1) -> bool:
    """Whether the conv of ``x`` by ``w`` takes K5 or K6 for its weight
    gradient, from what the call holds: a 3D conv of float32 CUDA tensors
    with TF32 off for convs (``torch.backends.cudnn.allow_tf32`` False), a
    gradient wanted for ``w``, one group, no dilation, stride 1, padding at
    most kernel - 1 on each axis, and a shape that the kernel's plan takes:
    K6's (``pointwise_wgrad_cuda.plan``) for a 1x1x1 kernel, K5's
    (``conv_wgrad_cuda.plan``) for a larger one. Every other conv
    (bfloat16, TF32 on, 2D, no gradient, strided) keeps cuDNN.

    K5 takes y and x strides of 2 too, but a strided conv keeps cuDNN: at
    the one such conv of the LIDC models with a kernel larger than 1 (the
    7x7x7 stem of the stride-1 levels, stride (2, 2, 1)) cuDNN's float32
    weight gradient is 1.1e-4 off float64 in norm where K5's is 1.4e-7
    (PERF.md), and the benchmark's reference, which computes it with cuDNN,
    could then not tell K5's right answer from a wrong one. The strided
    1x1x1 shortcuts keep cuDNN on the same ground."""
    if x.dim() != 5 or w.dim() != 5 or groups != 1 or tuple(dilation) != (1, 1, 1):
        return False
    if x.dtype != torch.float32 or w.dtype != torch.float32 or not (on_card(x) and on_card(w)):
        return False
    if torch.backends.cudnn.allow_tf32 or not (torch.is_grad_enabled() and w.requires_grad):
        return False
    k = tuple(w.shape[2:])
    if tuple(stride) != (1, 1, 1) or any(p < 0 or p > n - 1 for p, n in zip(padding, k)):
        return False
    if math.prod(k) == 1:
        from medicaldetectiontoolkit_torch.ops import pointwise_wgrad_cuda

        return pointwise_wgrad_cuda.takes((x.shape[0], x.shape[1], math.prod(x.shape[2:]), w.shape[0]))
    from medicaldetectiontoolkit_torch.ops import conv_wgrad_cuda

    return conv_wgrad_cuda.takes((*x.shape, w.shape[0], *k, stride[0], stride[1], *padding))


def conv3d_wgrad_reference(x, dy, kernel_size, stride, padding):
    """Plain version of K5: dw (cout, cin, *kernel_size) in x's dtype, per
    tap the output gradient as a (cout, voxels) matrix times the padded
    input under the tap."""
    (ky, kx, kz), (sy, sx, sz), (py, px, pz) = kernel_size, stride, padding
    C, M = x.shape[1], dy.shape[1]
    Yo, Xo, Zo = dy.shape[2:]
    xp = F.pad(x, (pz, pz, px, px, py, py))
    gm = dy.transpose(0, 1).reshape(M, -1)
    dw = x.new_empty((M, C, ky, kx, kz))
    for a in range(ky):
        for b in range(kx):
            for c in range(kz):
                tap = xp[:, :, a:a + sy * (Yo - 1) + 1:sy, b:b + sx * (Xo - 1) + 1:sx, c:c + sz * (Zo - 1) + 1:sz]
                dw[:, :, a, b, c] = gm @ tap.transpose(0, 1).reshape(C, -1).T
    return dw


def conv3d_wgrad(x, dy, kernel_size, stride, padding):
    """K5 on the tensors' device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors. Each call adds 1 to the ``k5.calls``
    counter (``utils/trace.py``)."""
    trace.count("k5.calls", 1)
    if x.device.type == "cpu":
        return conv3d_wgrad_reference(x, dy, kernel_size, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"no conv weight-gradient implementation for device {x.device}")
    from medicaldetectiontoolkit_torch.ops import conv_wgrad_cuda

    return conv_wgrad_cuda.conv3d_wgrad(x, dy, kernel_size, stride, padding)


class Conv3dWgradFunction(torch.autograd.Function):
    """``F.conv3d`` with K5 or K6 for dw: forward ``F.conv3d``; in the
    backward dx, only where x needs it, from ``aten.convolution_backward``
    (cuDNN's dgrad, as before), dw from K6 for a 1x1x1 kernel and from K5
    otherwise, db the sum of dy over the batch and voxels."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = (tuple(stride), tuple(padding))
        return F.conv3d(x, w, b, stride, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geometry
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(dy, x, w, None, stride, padding, (1, 1, 1), False, (0, 0, 0),
                                                     1, (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            k = tuple(w.shape[2:])
            dw = (pointwise_wgrad.pointwise_wgrad(x, dy).view(w.shape) if math.prod(k) == 1
                  else conv3d_wgrad(x, dy, k, stride, padding))
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2, 3, 4))
        return dx, dw, db, None, None
