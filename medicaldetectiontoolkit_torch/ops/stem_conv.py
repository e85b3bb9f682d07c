"""The tiny-cin 3D stem conv of the opt-in stem path (torch): the plain
versions of kernels K3 and K4, their device-keyed dispatchers, the autograd
function that joins them, and the gate that decides which convs take them.

Counterpart of ``medicaldetectiontoolkit_tpu/ops/stem_conv_pallas.py``
(``stem_conv3d`` with its custom VJP, ``stem_pallas_viable``). Tensors are
channel-first, as the port's convs take them: x ``(B, cin, Y, X, Z)``, w
``(cout, cin, k, k, k)``, output ``(B, cout, ceil(Y/sy), ceil(X/sx), Z)``.
The numbers are JAX's: float32 accumulation, a cast to the compute dtype,
then the bias added in that dtype.

CPU tensors take the plain versions; CUDA tensors launch the kernels of
``ops/stem_conv_cuda.py`` (``csrc/stem_conv.cu``) or raise. There is no
third path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# JAX's residency bound on the banded weight (``stem_conv_pallas.py:350``)
_BAND_BYTES = 9 * 2**20


def stem_viable(x_shape, k: int, stride, pad: int) -> bool:
    """Whether a conv takes the stem kernels: ``stem_pallas_viable``
    (``stem_conv_pallas.py:350-363``) on the LOGICAL channel-last shape
    ``(B, Y, X, Z, cin)``, so that the same convs take it as in JAX. Odd
    stem geometry (SAME pad, z stride 1, y/x stride <= 2), k >= 3, cin <= 2,
    and JAX's residency bound on the banded weight it no longer builds."""
    if len(x_shape) != 5 or len(stride) != 3 or stride[2] != 1:
        return False
    if pad != k // 2 or stride[0] > 2 or stride[1] > 2:
        return False
    Z, cin = x_shape[-2], x_shape[-1]
    if k < 3 or cin > 2:
        return False
    t_bytes = k * k * (Z * cin) * Z * 2 * 4
    return Z * cin <= 256 and t_bytes <= _BAND_BYTES


def _same_pad(x, k: int, sy: int, sx: int):
    """Zero-pad (B, C, Y, X, Z) for SAME output ceil(Y/sy) x ceil(X/sx) x Z:
    k//2 before, what the last output window reaches after
    (``stem_conv_pallas.py:74-92``)."""
    _, _, Y, X, _ = x.shape
    p = k // 2
    y_hi = sy * (-(-Y // sy) - 1) + k - 1 - p - (Y - 1)
    x_hi = sx * (-(-X // sx) - 1) + k - 1 - p - (X - 1)
    return F.pad(x, (p, p, p, x_hi, p, y_hi))


def _taps(x, k: int, sy: int, sx: int):
    """Yield (ky, kx, kz, tap): the padded float32 input under each filter
    tap, (B, cin, Yo, Xo, Z)."""
    B, _, Y, X, Z = x.shape
    Yo, Xo = -(-Y // sy), -(-X // sx)
    xp = _same_pad(x.to(torch.float32), k, sy, sx)
    for ky in range(k):
        for kx in range(k):
            for kz in range(k):
                yield ky, kx, kz, xp[:, :, ky:ky + sy * (Yo - 1) + 1:sy, kx:kx + sx * (Xo - 1) + 1:sx, kz:kz + Z]


def stem_conv3d_reference(x, w, b, sy: int, sx: int):
    """Plain version of K3: a direct float32 sum over the filter taps, cast
    to x's dtype, then the bias added in that dtype."""
    B, cin, Y, X, Z = x.shape
    cout, k = w.shape[0], w.shape[-1]
    wf = w.to(torch.float32)
    acc = torch.zeros((B, cout, -(-Y // sy), -(-X // sx), Z), dtype=torch.float32, device=x.device)
    for ky, kx, kz, tap in _taps(x, k, sy, sx):
        for ci in range(cin):
            acc.addcmul_(tap[:, ci:ci + 1], wf[:, ci, ky, kx, kz].view(1, cout, 1, 1, 1))
    return acc.to(x.dtype) + b.to(x.dtype).view(1, cout, 1, 1, 1)


def stem_wgrad_reference(x, g, k: int, sy: int, sx: int):
    """Plain version of K4: dw (cout, cin, k, k, k) float32, the sum over
    (b, yo, xo, z) of the padded input under each tap times the output
    gradient g (B, cout, Yo, Xo, Z)."""
    cout, cin = g.shape[1], x.shape[1]
    gm = g.to(torch.float32).transpose(0, 1).reshape(cout, -1)
    dw = torch.empty((cout, cin, k, k, k), dtype=torch.float32, device=x.device)
    for ky, kx, kz, tap in _taps(x, k, sy, sx):
        dw[:, :, ky, kx, kz] = gm @ tap.transpose(0, 1).reshape(cin, -1).T
    return dw


def _cuda_module(t):
    if t.device.type != "cuda":
        raise ValueError(f"no stem conv implementation for device {t.device}")
    from medicaldetectiontoolkit_torch.ops import stem_conv_cuda

    return stem_conv_cuda


def stem_conv3d(x, w, b, sy: int, sx: int):
    """K3 on the tensors' device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return stem_conv3d_reference(x, w, b, sy, sx)
    return _cuda_module(x).stem_conv3d(x, w, b, sy, sx)


def stem_wgrad(x, g, k: int, sy: int, sx: int):
    """K4 on the tensors' device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return stem_wgrad_reference(x, g, k, sy, sx)
    return _cuda_module(x).stem_wgrad(x, g, k, sy, sx)


class StemConv3dFunction(torch.autograd.Function):
    """The stem conv with its backward (``stem_conv_pallas.py:264-347``):
    forward K3; dw from K4, cast to w's dtype; db a plain float32 sum cast to
    b's dtype; dx, only when x needs it, from ``conv3d_input`` (JAX takes dx
    from XLA outside any kernel too). On the model's stems x is the image,
    which needs no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, sy: int, sx: int):
        ctx.save_for_backward(x, w)
        ctx.strides = (sy, sx)
        return stem_conv3d(x, w, b, sy, sx)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        sy, sx = ctx.strides
        k = w.shape[-1]
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(x.shape, w, g, stride=(sy, sx, 1), padding=k // 2)
        if ctx.needs_input_grad[1]:
            dw = stem_wgrad(x, g, k, sy, sx).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3, 4), dtype=torch.float32).to(w.dtype)
        return dx, dw, db, None, None
