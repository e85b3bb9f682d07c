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

Tensors are channel-first ``(b, c, y, x, (z))``. Every conv holds a plain
``Conv2d``/``Conv3d``. The JAX package's XLA conv rewrites (``_ZFoldedConv``,
``_ZBandedConv``, ``_ZBlockBandedConv``) exist only to avoid the TPU's
128-lane padding and hold the same logical kernel, so they have no
counterpart here. Its opt-in Pallas stem does: with ``MDT_STEM_PALLAS=1`` a
3D conv that ``stem_viable`` admits runs the stem kernels K3 (forward) and
K4 (weight gradient) through ``ops/stem_conv.py``, as in JAX
(``backbone.py:344-362``); its parameters stay those of ``nn.Conv3d``.

``remat`` (on by default in 3D, ``resolve_remat``) recomputes the stem
convs, the ResBlocks and the full-resolution laterals in the backward pass
(``torch.utils.checkpoint`` through ``mesh.checkpoint``, which gives the
recomputation the forward's SpaceGroup), where JAX wraps them in
``maybe_remat``.

``dtype`` is the compute dtype: params stay float32 and are cast at each
conv, as flax's ``nn.Conv(dtype=...)`` does.

Under spatial partitioning (``parallel/mesh.py``, inside
``SpaceGroup.train`` or ``run``) each rank holds a Y slab of every split
level: padded and strided convs, the max pool and ``linear_up`` take their
neighbours' rows through ``mesh.halo_exchange``, GroupNorm sums its
statistics over the space group, and ``FPN`` gathers a level that no longer
splits (``mesh.space_fence``) and runs it and the deeper ones replicated;
``FPN.slab_levels`` says which of its outputs are slabs. Each of these
primitives has its backward collective (``mesh``'s gradient convention), so
the same code trains: no op here needs its own backward rule.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from medicaldetectiontoolkit_torch.ops.stem_conv import StemConv3dFunction, stem_viable
from medicaldetectiontoolkit_torch.parallel import mesh

# flax nn.GroupNorm's default epsilon (torch's default is 1e-5)
GN_EPS = 1e-6


def _variance_scaling(shape, scale: float, mode: str, distribution: str, generator, in_axis: int = 1):
    """flax/jax ``variance_scaling`` draw for a torch weight shape: conv
    (cout, cin, k...) and Linear (out, in) with ``in_axis`` 1, transposed conv
    (cin, cout, k...) with ``in_axis`` 0; fan_in = cin*prod(k), fan_out =
    cout*prod(k). Drawn on the CPU so a seed gives the same weights on every
    device."""
    receptive = math.prod(shape[2:])
    fan_in, fan_out = shape[in_axis] * receptive, shape[1 - in_axis] * receptive
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
    (``backbone.py:30-42``): conv kernels by ``cf.weight_init``, zero biases,
    unit norm scales. Linear and transposed-conv layers are flax ``Dense``
    and ``ConvTranspose`` in JAX, which take flax's default init
    (lecun_normal) whatever ``cf.weight_init`` says. The draws differ from
    JAX's; parity tests load converted JAX params instead."""
    if weight_init not in _INITS:
        raise ValueError(f"unknown weight_init '{weight_init}'")
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, nn.ConvTranspose2d, nn.ConvTranspose3d)):
                flax_default = isinstance(m, (nn.Linear, nn.ConvTranspose2d, nn.ConvTranspose3d))
                scale, mode, dist = _INITS[None if flax_default else weight_init]
                in_axis = 0 if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)) else 1
                m.weight.copy_(_variance_scaling(tuple(m.weight.shape), scale, mode, dist, generator, in_axis))
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def _flax_group_norm(x, norm: nn.GroupNorm):
    """GroupNorm with flax's formula: the "fast" variance E[x^2] - E[x]^2
    clamped at 0, then (x - mean) * (rsqrt(var + eps) * scale) + bias.
    Matching flax matters where a group holds few values (instance norm on
    the deepest levels), where the variance is ill-conditioned and torch's
    two-pass variance gives other numbers.

    The sums of x and x^2 are taken in float64 (flax: float32), and on a Y
    slab summed over the space group: there, in float32, the order of
    summation alone moves E[x^2] - E[x]^2 by as much as its float32
    rounding does, so a slab's statistics and one process's would part; in
    float64 they agree, and so do the steps that train on them."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xg = x.float().reshape(b, g, c // g, -1)
    xd = xg.double()
    sums = mesh.space_sum(torch.stack([xd.sum(dim=(2, 3)), xd.square().sum(dim=(2, 3))]))
    sg = mesh.space()
    mean, mean_sq = (sums / (xg.shape[2] * xg.shape[3] * (1 if sg is None else sg.size)))[..., None, None]
    var = torch.clamp_min(mean_sq - mean.square(), 0.0).float()
    mul = torch.rsqrt(var + norm.eps) * norm.weight.view(1, g, c // g, 1)
    y = (xg - mean.float()) * mul + norm.bias.view(1, g, c // g, 1)
    return y.reshape(x.shape)


class ConvND(nn.Module):
    """conv + optional norm + optional nonlinearity (``backbone.py:313-435``).

    ``norm``: ``"batch_norm"`` is GroupNorm with one group (batch-statistics
    free, ``backbone.py:422-426``), ``"instance_norm"`` GroupNorm with one
    channel per group, both computed as flax does (``_flax_group_norm``).

    With ``MDT_STEM_PALLAS=1`` a 3D conv that ``stem_viable`` admits for its
    input runs ``StemConv3dFunction`` (K3, and K4 in the backward). The path
    is chosen from the input's shape at each call, as JAX chooses it at each
    trace; ``stem_kernel`` records the last choice. ``remat`` recomputes the
    layer in the backward pass.

    On a Y slab a conv with ``k > 1`` or a Y stride takes ``k // 2`` rows
    before the slab and ``k - stride - k // 2`` after (``mesh.halo_exchange``,
    zeros at the image's edge) and runs with no Y padding; the slab's rows
    must divide by the stride, so that its first row is aligned. K3 pads by
    itself: it takes a halo before the slab rounded up to the stride and its
    surplus outputs are cropped.
    """

    def __init__(self, dim: int, cin: int, cout: int, ks: int = 1, stride=1, pad: int = 0,
                 norm: Optional[str] = None, relu: Optional[str] = "relu", dtype=torch.float32, remat: bool = False):
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
        self.remat = remat
        self.stem_kernel = False

    def _takes_stem_kernel(self, x) -> bool:
        """JAX's gate (``backbone.py:343-356``) on the logical shape of ``x``."""
        c = self.conv
        if not isinstance(c, nn.Conv3d) or os.environ.get("MDT_STEM_PALLAS") != "1":
            return False
        b, cin, y, xx, z = x.shape
        return stem_viable((b, y, xx, z, cin), c.kernel_size[0], c.stride, c.padding[0])

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            return mesh.checkpoint(self._forward, x)
        return self._forward(x)

    def _forward(self, x):
        c = self.conv
        x, w, b = x.to(self.dtype), c.weight.to(self.dtype), c.bias.to(self.dtype)
        # the gate reads no Y extent: a slab takes the kernel where the whole image does
        self.stem_kernel = self._takes_stem_kernel(x)
        if mesh.space() is not None and (c.kernel_size[0] > 1 or c.stride[0] > 1):
            x = self._slab_conv(x, w, b)
        elif self.stem_kernel:
            x = StemConv3dFunction.apply(x, w, b, c.stride[0], c.stride[1])
        else:
            x = (F.conv2d if isinstance(c, nn.Conv2d) else F.conv3d)(x, w, b, c.stride, c.padding)
        if self.norm is not None:
            x = _flax_group_norm(x, self.norm).to(self.dtype)
        if self.relu == "relu":
            x = F.relu(x)
        elif self.relu == "leaky_relu":
            x = F.leaky_relu(x, 0.01)
        return x

    def _slab_conv(self, x, w, b):
        """The conv of ``x``, this rank's Y slab, giving the output rows of
        the slab."""
        c = self.conv
        k, s, p = c.kernel_size[0], c.stride[0], c.padding[0]
        n = x.shape[2]
        if n % s:
            raise ValueError(f"a Y slab of {n} rows does not align with the conv's stride {s}")
        hi = max(k - s - p, 0)
        if self.stem_kernel:
            lo = -(-p // s) * s
            out = StemConv3dFunction.apply(mesh.halo_exchange(x, lo, hi), w, b, s, c.stride[1])
            return out[:, :, lo // s:lo // s + n // s]
        conv = F.conv2d if isinstance(c, nn.Conv2d) else F.conv3d
        return conv(mesh.halo_exchange(x, p, hi), w, b, c.stride, (0, *c.padding[1:]))


class ResBlock(nn.Module):
    """Bottleneck block: 1x1 (stride) -> 3x3 -> 1x1 x4 + residual
    (``backbone.py:438-462``); ``remat`` recomputes it in the backward pass."""

    def __init__(self, dim, cin, planes, stride=1, downsample=False, norm=None, relu="relu",
                 dtype=torch.float32, remat=False):
        super().__init__()
        kw = dict(norm=norm, dtype=dtype)
        self.conv1 = ConvND(dim, cin, planes, ks=1, stride=stride, relu=relu, **kw)
        self.conv2 = ConvND(dim, planes, planes, ks=3, pad=1, relu=relu, **kw)
        self.conv3 = ConvND(dim, planes, planes * 4, ks=1, relu=None, **kw)
        self.downsample = (
            ConvND(dim, cin, planes * 4, ks=1, stride=stride, relu=None, **kw) if downsample else None
        )
        self.relu = relu
        self.remat = remat

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            return mesh.checkpoint(self._forward, x)
        return self._forward(x)

    def _forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        out = out + (self.downsample(x) if self.downsample is not None else x)
        return F.relu(out) if self.relu == "relu" else F.leaky_relu(out, 0.01)


def res_stage(dim, cin, planes, n_blocks, stride, norm, relu, dtype, remat=False) -> nn.Sequential:
    """First (strided, projected) block + identity blocks (``backbone.py:506-547``).

    The JAX package runs the identity blocks under ``nn.scan`` (stacked
    params) or a Python loop; here they are a plain ``nn.Sequential``, and
    ``utils/convert.py`` unstacks scanned params into it.
    """
    kw = dict(norm=norm, relu=relu, dtype=dtype, remat=remat)
    blocks = [ResBlock(dim, cin, planes, stride, downsample=True, **kw)]
    blocks += [ResBlock(dim, planes * 4, planes, **kw) for _ in range(n_blocks - 1)]
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
    including the clamped edge voxels. A Y slab takes one row on each side
    (the edge row repeated at the image's edge), is interpolated at the same
    scale and loses ``factor`` output rows on each side.
    """
    mode = "bilinear" if x.dim() == 4 else "trilinear"
    if mesh.space() is None:
        size = [int(s * f) for s, f in zip(x.shape[2:], factor)]
        return F.interpolate(x, size=size, mode=mode, align_corners=False)
    fy, n = int(factor[0]), x.shape[2]
    size = [(n + 2) * fy] + [int(s * f) for s, f in zip(x.shape[3:], factor[1:])]
    out = F.interpolate(mesh.halo_exchange(x, 1, 1, "replicate"), size=size, mode=mode, align_corners=False)
    return out[:, :, fy:fy + n * fy]


def maxpool(x, dim):
    """3-window max pool, stride (2,2,1) in 3D, padded with -inf
    (``backbone.py:566-569``). A Y slab takes one row before it (-inf at
    the image's edge) and pools with no Y padding."""
    stride = (2, 2, 1) if dim == 3 else 2
    pool = F.max_pool3d if dim == 3 else F.max_pool2d
    if mesh.space() is None:
        return pool(x, 3, stride=stride, padding=1)
    if x.shape[2] % 2:
        raise ValueError(f"a Y slab of {x.shape[2]} rows does not align with the max pool's stride 2")
    return pool(mesh.halo_exchange(x, 1, 0, float("-inf")), 3, stride=stride, padding=(0,) + (1,) * (dim - 1))


class FPN(nn.Module):
    """Feature pyramid: returns [P2..P5(,P6)] or [P0, P2..] with operate_stride1
    (``backbone.py:572-661``); indexing by ``cf.pyramid_levels`` works as in
    the reference."""

    def __init__(self, dim, n_channels, start_filts, end_filts, res_architecture="resnet50", norm=None,
                 relu="relu", sixth_pooling=False, operate_stride1=False, dtype=torch.float32, remat=False):
        super().__init__()
        self.dim = dim
        self.operate_stride1 = operate_stride1
        self.sixth_pooling = sixth_pooling
        self.slab_levels = ()  # of the last forward: which outputs are Y slabs
        sf, ef = start_filts, end_filts
        self.n_blocks = [3, 4, {"resnet50": 6, "resnet101": 23}[res_architecture], 3]
        kw = dict(norm=norm, relu=relu, dtype=dtype)
        stem_stride = (2, 2, 1) if dim == 3 else 2

        if operate_stride1:
            self.stem0 = nn.Sequential(
                ConvND(dim, n_channels, sf, ks=3, pad=1, remat=remat, **kw),
                ConvND(dim, sf, sf, ks=3, pad=1, remat=remat, **kw),
            )
            self.stem1 = ConvND(dim, sf, sf, ks=7, stride=stem_stride, pad=3, remat=remat, **kw)
        else:
            self.stem0 = None
            self.stem1 = ConvND(dim, n_channels, sf, ks=7, stride=stem_stride, pad=3, remat=remat, **kw)

        # (cin, planes, stride) of C2..C5(, C6)
        stages = [(sf, sf, 1), (sf * 4, sf * 2, 2), (sf * 8, sf * 4, 2), (sf * 16, sf * 8, 2)]
        n_blocks = list(self.n_blocks)
        if sixth_pooling:
            stages.append((sf * 32, sf * 16, 2))
            n_blocks.append(self.n_blocks[3])
        self.stages = nn.ModuleList(
            res_stage(dim, cin, planes, nb, stride, remat=remat, **kw)
            for (cin, planes, stride), nb in zip(stages, n_blocks)
        )

        lat = dict(relu=None, dtype=dtype)
        c_out = [sf * 4, sf * 8, sf * 16, sf * 32] + ([sf * 64] if sixth_pooling else [])
        # laterals and output convs of P2..P5(,P6)
        self.lateral = nn.ModuleList(ConvND(dim, c, ef, ks=1, **lat) for c in c_out)
        self.out = nn.ModuleList(ConvND(dim, ef, ef, ks=3, pad=1, **lat) for _ in c_out)
        if operate_stride1:
            # the full-resolution levels are recomputed too (``backbone.py:655``)
            self.lateral1 = ConvND(dim, sf, ef, ks=1, remat=remat, **lat)
            self.lateral0 = ConvND(dim, sf, ef, ks=1, remat=remat, **lat)
            self.out0 = ConvND(dim, ef, ef, ks=3, pad=1, remat=remat, **lat)

    def forward(self, x):
        """Under spatial partitioning ``x`` is this rank's Y slab of the
        image; ``self.slab_levels`` then says which outputs are slabs (the
        others whole), as ``mesh.space_fence`` decided at each stage input."""
        d = self.dim
        split = mesh.space() is not None
        if self.operate_stride1:
            x, split0 = mesh.space_fence(x, split)
            with mesh.on_slabs(split0):
                c0 = self.stem0(x)
        else:
            c0, split0 = x, split
        # stem1 reads 3 rows before its output (4 for K3, whose halo rounds up to the stride)
        h, split1 = mesh.space_fence(c0, split0, stride=2, halo=4)
        with mesh.on_slabs(split1):
            c1 = self.stem1(h)
        h, split_h = mesh.space_fence(c1, split1, stride=2)
        with mesh.on_slabs(split_h):
            h = maxpool(h, d)
        cs, splits = [], []
        for i, stage in enumerate(self.stages):
            h, split_h = mesh.space_fence(h, split_h, stride=1 if i == 0 else 2)
            with mesh.on_slabs(split_h):
                h = stage(h)
            cs.append(h)  # C2..C5(, C6)
            splits.append(split_h)

        def joined(t, split_t, split_to):
            # a whole (replicated) tensor added to a slab: this rank's rows
            return mesh.slab_of(t) if split_to and not split_t else t

        up2 = (2,) * d
        pre = [None] * len(cs)
        with mesh.on_slabs(splits[-1]):
            pre[-1] = self.lateral[-1](cs[-1])
        for i in range(len(cs) - 2, -1, -1):
            up = joined(nearest_up(pre[i + 1], up2), splits[i + 1], splits[i])
            with mesh.on_slabs(splits[i]):
                pre[i] = self.lateral[i](cs[i]) + up
        out = []
        for i in range(len(cs)):
            with mesh.on_slabs(splits[i]):
                out.append(self.out[i](pre[i]))
        self.slab_levels = tuple(splits)

        if self.operate_stride1:
            up_aniso = (2, 2, 1) if d == 3 else (2, 2)
            with mesh.on_slabs(splits[0]):
                up = linear_up(pre[0], up_aniso)
            with mesh.on_slabs(split1):
                p1_pre = self.lateral1(c1) + joined(up, splits[0], split1)
                up = linear_up(p1_pre, up_aniso)
            with mesh.on_slabs(split0):
                p0_pre = self.lateral0(c0) + joined(up, split1, split0)
                out = [self.out0(p0_pre)] + out
            self.slab_levels = (split0,) + self.slab_levels
        return out
