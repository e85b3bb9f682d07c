"""Shared FPN backbone (ResNet-50/101 encoder + top-down decoder), 2D + 3D (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/models/backbone.py`` with the
same topology and geometry:

  * encoder C1..C5(+C6): 7x7 stride-2 stem (stride (2,2,1) in 3D), 3x3 max
    pool with stride (2,2,1) in 3D, bottleneck ResBlocks [3, 4, 6|23, 3]
    with expansion 4; stages C3..C5(C6) downsample by 2 in every axis;
  * decoder: 1x1 laterals + nearest x2 up-sampling, 3x3 output convs,
    ``end_filts`` channels at every level;
  * ``operate_stride1`` adds a C0 stem before C1 and P1/P0 decoder levels
    with (bi/tri)linear (2,2,1) up-sampling;
  * ``sixth_pooling`` appends C6/P6.

Tensors are channel-first ``(b, c, y, x, (z))``. Every conv is a plain
``Conv2d``/``Conv3d``: the JAX package's TPU-only conv rewrites
(``_ZFoldedConv``, ``_ZBandedConv``, ``_ZBlockBandedConv``, the opt-in Pallas
stem) exist only to avoid the TPU's 128-lane padding and hold the same
logical kernel, so they have no counterpart here.

``dtype`` is the compute dtype: params stay float32 and are cast at each
conv, as flax's ``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax nn.GroupNorm's default epsilon (torch's default is 1e-5)
GN_EPS = 1e-6


def _variance_scaling(shape, scale: float, mode: str, distribution: str, generator):
    """flax/jax ``variance_scaling`` draw for a torch conv weight shape
    (cout, cin, k...): fan_in = cin*prod(k), fan_out = cout*prod(k).
    Drawn on the CPU so a seed gives the same weights on every device."""
    receptive = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
    var = scale / fan
    w = torch.empty(shape, dtype=torch.float32)
    if distribution == "uniform":
        lim = math.sqrt(3.0 * var)
        return w.uniform_(-lim, lim, generator=generator)
    # truncated normal on [-2, 2] std, rescaled to the target variance
    std = math.sqrt(var) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


_INITS = {
    None: (1.0, "fan_in", "normal"),  # lecun_normal, flax's default
    "xavier_uniform": (1.0, "fan_avg", "uniform"),
    "xavier_normal": (1.0, "fan_avg", "normal"),
    "kaiming_uniform": (2.0, "fan_in", "uniform"),
    "kaiming_normal": (2.0, "fan_in", "normal"),
}


def init_weights(module: nn.Module, weight_init: Optional[str], generator: torch.Generator):
    """Re-initialise every conv and norm of ``module`` like the JAX package
    (``backbone.py:30-42``): kernels by ``cf.weight_init``, zero biases,
    unit norm scales. The draws differ from JAX's; parity tests load
    converted JAX params instead."""
    if weight_init not in _INITS:
        raise ValueError(f"unknown weight_init '{weight_init}'")
    scale, mode, dist = _INITS[weight_init]
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                m.weight.copy_(_variance_scaling(tuple(m.weight.shape), scale, mode, dist, generator))
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def _flax_group_norm(x, norm: nn.GroupNorm):
    """GroupNorm as flax computes it: float32 statistics, the "fast"
    variance E[x^2] - E[x]^2 clamped at 0, then (x - mean) * (rsqrt(var +
    eps) * scale) + bias. Matching flax matters where a group holds few
    values (instance norm on the deepest levels), where the variance is
    ill-conditioned and torch's two-pass variance gives other numbers."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xg = x.float().reshape(b, g, c // g, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min(xg.square().mean(dim=(2, 3), keepdim=True) - mean.square(), 0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.view(1, g, c // g, 1)
    y = (xg - mean) * mul + norm.bias.view(1, g, c // g, 1)
    return y.reshape(x.shape)


class ConvND(nn.Module):
    """conv + optional norm + optional nonlinearity (``backbone.py:313-435``).

    ``norm``: ``"batch_norm"`` is GroupNorm with one group (batch-statistics
    free, ``backbone.py:422-426``), ``"instance_norm"`` GroupNorm with one
    channel per group, both computed as flax does (``_flax_group_norm``).
    """

    def __init__(self, dim: int, cin: int, cout: int, ks: int = 1, stride=1, pad: int = 0,
                 norm: Optional[str] = None, relu: Optional[str] = "relu", dtype=torch.float32):
        super().__init__()
        conv = nn.Conv2d if dim == 2 else nn.Conv3d
        self.conv = conv(cin, cout, ks, stride=stride, padding=pad)
        if norm == "batch_norm":
            self.norm = nn.GroupNorm(1, cout, eps=GN_EPS)
        elif norm == "instance_norm":
            self.norm = nn.GroupNorm(cout, cout, eps=GN_EPS)
        elif norm is None:
            self.norm = None
        else:
            raise ValueError(f"unknown norm '{norm}'")
        if relu not in (None, "relu", "leaky_relu"):
            raise ValueError(f"unknown relu '{relu}'")
        self.relu = relu
        self.dtype = dtype

    def forward(self, x):
        c = self.conv
        conv = F.conv2d if isinstance(c, nn.Conv2d) else F.conv3d
        x = conv(x.to(self.dtype), c.weight.to(self.dtype), c.bias.to(self.dtype), c.stride, c.padding)
        if self.norm is not None:
            x = _flax_group_norm(x, self.norm).to(self.dtype)
        if self.relu == "relu":
            x = F.relu(x)
        elif self.relu == "leaky_relu":
            x = F.leaky_relu(x, 0.01)
        return x


class ResBlock(nn.Module):
    """Bottleneck block: 1x1 (stride) -> 3x3 -> 1x1 x4 + residual
    (``backbone.py:438-462``)."""

    def __init__(self, dim, cin, planes, stride=1, downsample=False, norm=None, relu="relu",
                 dtype=torch.float32):
        super().__init__()
        kw = dict(norm=norm, dtype=dtype)
        self.conv1 = ConvND(dim, cin, planes, ks=1, stride=stride, relu=relu, **kw)
        self.conv2 = ConvND(dim, planes, planes, ks=3, pad=1, relu=relu, **kw)
        self.conv3 = ConvND(dim, planes, planes * 4, ks=1, relu=None, **kw)
        self.downsample = (
            ConvND(dim, cin, planes * 4, ks=1, stride=stride, relu=None, **kw) if downsample else None
        )
        self.relu = relu

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        out = out + (self.downsample(x) if self.downsample is not None else x)
        return F.relu(out) if self.relu == "relu" else F.leaky_relu(out, 0.01)


def res_stage(dim, cin, planes, n_blocks, stride, norm, relu, dtype) -> nn.Sequential:
    """First (strided, projected) block + identity blocks (``backbone.py:506-547``).

    The JAX package runs the identity blocks under ``nn.scan`` (stacked
    params) or a Python loop; here they are a plain ``nn.Sequential``, and
    ``utils/convert.py`` unstacks scanned params into it.
    """
    blocks = [ResBlock(dim, cin, planes, stride, downsample=True, norm=norm, relu=relu, dtype=dtype)]
    blocks += [ResBlock(dim, planes * 4, planes, norm=norm, relu=relu, dtype=dtype) for _ in range(n_blocks - 1)]
    return nn.Sequential(*blocks)


def nearest_up(x, factor):
    """Nearest-neighbour up-sampling by integer factors per spatial axis
    (``backbone.py:550-556``); exact for integer factors."""
    size = [s * f for s, f in zip(x.shape[2:], factor)]
    return F.interpolate(x, size=size, mode="nearest")


def linear_up(x, factor):
    """(Bi/tri)linear up-sampling with half-pixel centres.

    ``jax.image.resize(..., "linear")`` (``backbone.py:559-563``) equals
    ``align_corners=False`` interpolation for these integer factors,
    including the clamped edge voxels.
    """
    size = [int(s * f) for s, f in zip(x.shape[2:], factor)]
    return F.interpolate(x, size=size, mode="bilinear" if x.dim() == 4 else "trilinear", align_corners=False)


def maxpool(x, dim):
    """3-window max pool, stride (2,2,1) in 3D, padded with -inf (``backbone.py:566-569``)."""
    if dim == 3:
        return F.max_pool3d(x, 3, stride=(2, 2, 1), padding=1)
    return F.max_pool2d(x, 3, stride=2, padding=1)


class FPN(nn.Module):
    """Feature pyramid: returns [P2..P5(,P6)] or [P0, P2..] with operate_stride1
    (``backbone.py:572-661``); indexing by ``cf.pyramid_levels`` works as in
    the reference."""

    def __init__(self, dim, n_channels, start_filts, end_filts, res_architecture="resnet50", norm=None,
                 relu="relu", sixth_pooling=False, operate_stride1=False, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.operate_stride1 = operate_stride1
        self.sixth_pooling = sixth_pooling
        sf, ef = start_filts, end_filts
        self.n_blocks = [3, 4, {"resnet50": 6, "resnet101": 23}[res_architecture], 3]
        kw = dict(norm=norm, relu=relu, dtype=dtype)
        stem_stride = (2, 2, 1) if dim == 3 else 2

        if operate_stride1:
            self.stem0 = nn.Sequential(
                ConvND(dim, n_channels, sf, ks=3, pad=1, **kw),
                ConvND(dim, sf, sf, ks=3, pad=1, **kw),
            )
            self.stem1 = ConvND(dim, sf, sf, ks=7, stride=stem_stride, pad=3, **kw)
        else:
            self.stem0 = None
            self.stem1 = ConvND(dim, n_channels, sf, ks=7, stride=stem_stride, pad=3, **kw)

        # (cin, planes, stride) of C2..C5(, C6)
        stages = [(sf, sf, 1), (sf * 4, sf * 2, 2), (sf * 8, sf * 4, 2), (sf * 16, sf * 8, 2)]
        n_blocks = list(self.n_blocks)
        if sixth_pooling:
            stages.append((sf * 32, sf * 16, 2))
            n_blocks.append(self.n_blocks[3])
        self.stages = nn.ModuleList(
            res_stage(dim, cin, planes, nb, stride, **kw) for (cin, planes, stride), nb in zip(stages, n_blocks)
        )

        lat = dict(relu=None, dtype=dtype)
        c_out = [sf * 4, sf * 8, sf * 16, sf * 32] + ([sf * 64] if sixth_pooling else [])
        # laterals and output convs of P2..P5(,P6)
        self.lateral = nn.ModuleList(ConvND(dim, c, ef, ks=1, **lat) for c in c_out)
        self.out = nn.ModuleList(ConvND(dim, ef, ef, ks=3, pad=1, **lat) for _ in c_out)
        if operate_stride1:
            self.lateral1 = ConvND(dim, sf, ef, ks=1, **lat)
            self.lateral0 = ConvND(dim, sf, ef, ks=1, **lat)
            self.out0 = ConvND(dim, ef, ef, ks=3, pad=1, **lat)

    def forward(self, x):
        d = self.dim
        c0 = self.stem0(x) if self.operate_stride1 else x
        c1 = self.stem1(c0)
        cs = []
        h = maxpool(c1, d)
        for stage in self.stages:
            h = stage(h)
            cs.append(h)  # C2..C5(, C6)

        up2 = (2,) * d
        pre = [None] * len(cs)
        pre[-1] = self.lateral[-1](cs[-1])
        for i in range(len(cs) - 2, -1, -1):
            pre[i] = self.lateral[i](cs[i]) + nearest_up(pre[i + 1], up2)
        out = [self.out[i](pre[i]) for i in range(len(cs))]

        if self.operate_stride1:
            up_aniso = (2, 2, 1) if d == 3 else (2, 2)
            p1_pre = self.lateral1(c1) + linear_up(pre[0], up_aniso)
            p0_pre = self.lateral0(c0) + linear_up(p1_pre, up_aniso)
            out = [self.out0(p0_pre)] + out
        return out
