"""Pyramid anchor generation (torch, run once at model build).

Counterpart of ``medicaldetectiontoolkit_tpu/ops/anchors.py`` with the same
ordering contract: per pyramid level, anchors are laid out position-major in
(y, x, (z)) row-major order with the per-position anchor index minor, and the
per-position order iterates ratios (outer) x scales (inner). That is the
order in which ``DenseHead`` flattens its channel-last output.

3D anchors pair each xy-scale with a z-scale (depths tiled over the ratio
axis, ``anchors.py:68``). Coordinates are computed in float64 with the
same operations as the NumPy version, so the float32 anchors are identical.
"""

from __future__ import annotations

import math

import torch


def generate_anchors(scales_xy, ratios, feature_shape, feature_stride_xy, anchor_stride=1,
                     scales_z=None, feature_stride_z=None):
    """All anchors of one pyramid level: (P*A, 2*dim) float64,
    (y1, x1, y2, x2, (z1, z2)).

    ``scales_*`` in pixels, ``ratios`` = width/height, ``feature_shape`` the
    level's (y, x, (z)) extent, ``feature_stride_*`` pixels per feature cell.
    2D when ``scales_z`` is None (``anchors.py:21-48``), 3D otherwise
    (``anchors.py:51-98``).
    """
    f64 = dict(dtype=torch.float64)
    # per-position anchor order: ratio-major, scale-minor. The A extents are
    # host floats: math.sqrt is correctly rounded like np.sqrt, while
    # torch.sqrt on the CPU can differ in the last bit
    pairs = [(float(s), math.sqrt(float(r))) for r in ratios for s in scales_xy]
    extents = [[s / q for s, q in pairs], [s * q for s, q in pairs]]  # heights, widths
    strides = [feature_stride_xy, feature_stride_xy]
    if scales_z is not None:
        extents.append([float(z) for z in scales_z] * (len(pairs) // len(scales_z)))
        strides.append(feature_stride_z)
    extents = [torch.tensor(e, **f64) for e in extents]  # (A,) each

    axes = [torch.arange(0, n, anchor_stride, **f64) * s for n, s in zip(feature_shape, strides)]
    centers = [c.reshape(-1, 1) for c in torch.meshgrid(*axes, indexing="ij")]  # (P, 1) each, row-major
    lo = [c - 0.5 * e for c, e in zip(centers, extents)]  # (P, A) per axis
    hi = [c + 0.5 * e for c, e in zip(centers, extents)]
    cols = [lo[0], lo[1], hi[0], hi[1]] + ([lo[2], hi[2]] if scales_z is not None else [])
    return torch.stack(cols, dim=-1).reshape(-1, len(cols))


def generate_pyramid_anchors(cf, logger=None):
    """Anchors of every configured pyramid level, concatenated: (N, 2*dim)
    float64 on the CPU (``anchors.py:102-135``).

    Reads ``rpn_anchor_scales`` {'xy': .., 'z': ..}, ``rpn_anchor_ratios``,
    ``backbone_shapes``, ``backbone_strides``, ``rpn_anchor_stride`` and
    ``pyramid_levels``.
    """
    anchors = []
    for level in cf.pyramid_levels:
        shape = [int(s) for s in cf.backbone_shapes[level]]
        is_3d = len(shape) == 3
        a = generate_anchors(
            cf.rpn_anchor_scales["xy"][level],
            cf.rpn_anchor_ratios,
            shape,
            cf.backbone_strides["xy"][level],
            cf.rpn_anchor_stride,
            scales_z=cf.rpn_anchor_scales["z"][level] if is_3d else None,
            feature_stride_z=cf.backbone_strides["z"][level] if is_3d else None,
        )
        if logger is not None:
            logger.info(f"level {level}: built anchors {tuple(a.shape)}")
        anchors.append(a)
    return torch.cat(anchors, dim=0)
