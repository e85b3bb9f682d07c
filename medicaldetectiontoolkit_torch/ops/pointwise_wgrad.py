"""The weight gradient of the stride-1 1x1x1 3D convs (torch): the plain
version of kernel K6 and its device-keyed dispatcher.

K6 replaces no TPU kernel (the JAX package leaves these convs to XLA). It
takes cuDNN's place for the float32 weight gradient of a stride-1 1x1x1 3D
conv (the FPN's laterals, the ResNet bottlenecks' 1x1 convs, the heads'
1x1 outputs), where cuDNN's ``wgrad2d_grouped_direct_kernel`` ran at about
0.5% of the bytes' bound (PERF.md). ``ops/conv_wgrad.py``'s gate admits
these convs and its autograd function sends their dw here; the forward
stays ``F.conv3d`` and the input gradient cuDNN's.

Such a conv's dw is one product over the voxels: with x viewed as ``(B,
cin, V)`` and dy as ``(B, cout, V)``, ``dw[m, c] = sum over b and v of
dy[b, m, v] * x[b, c, v]``. CPU tensors take the plain version; CUDA
tensors launch the kernel of ``ops/pointwise_wgrad_cuda.py``
(``csrc/pointwise_wgrad.cu``) or raise. There is no third path.
"""

from __future__ import annotations

from medicaldetectiontoolkit_torch.utils import trace


def pointwise_wgrad_reference(x, dy):
    """Plain version of K6: dw ``(cout, cin)`` in x's dtype from x ``(B,
    cin, *spatial)`` and dy ``(B, cout, *spatial)``."""
    return dy.transpose(0, 1).reshape(dy.shape[1], -1) @ x.transpose(0, 1).reshape(x.shape[1], -1).T


def pointwise_wgrad(x, dy):
    """K6 on the tensors' device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors; dw ``(cout, cin)``. Each call adds 1 to
    the ``k6.calls`` counter (``utils/trace.py``)."""
    trace.count("k6.calls", 1)
    if x.device.type == "cpu":
        return pointwise_wgrad_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"no pointwise weight-gradient implementation for device {x.device}")
    from medicaldetectiontoolkit_torch.ops import pointwise_wgrad_cuda

    return pointwise_wgrad_cuda.pointwise_wgrad(x, dy)
