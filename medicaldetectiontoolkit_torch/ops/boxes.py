"""Box geometry ops, rank-polymorphic over 2D / 3D (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/ops/boxes.py``. Boxes are
``(..., 4)`` = (y1, x1, y2, x2) or ``(..., 6)`` = (y1, x1, y2, x2, z1, z2)
float tensors; the spatial rank is inferred from the trailing axis. Every
function keeps the JAX version's float32 operation order, so results agree
with it exactly up to the last-ulp differences of ``exp``/``log``.

Two IoU conventions exist and both are kept: plain IoU (``pixel_offset=0``)
for anchor matching and the legacy +1-pixel convention of the NMS kernels
(``pixel_offset=1``).
"""

from __future__ import annotations

import torch


def box_dim(boxes) -> int:
    """Spatial rank (2 or 3) of a (..., 4|6) box tensor."""
    n = boxes.shape[-1]
    if n == 4:
        return 2
    if n == 6:
        return 3
    raise ValueError(f"box array must have 4 or 6 trailing coords, got {n}")


def _split_corners(boxes):
    """Return per-axis (lo, hi) corner lists ordered (y, x, (z))."""
    dim = box_dim(boxes)
    lo = [boxes[..., 0], boxes[..., 1]]
    hi = [boxes[..., 2], boxes[..., 3]]
    if dim == 3:
        lo.append(boxes[..., 4])
        hi.append(boxes[..., 5])
    return lo, hi


def box_area(boxes, pixel_offset: float = 0.0):
    """Area (2D) or volume (3D) of boxes; (...,) result (``boxes.py:42-51``)."""
    lo, hi = _split_corners(boxes)
    area = torch.ones(boxes.shape[:-1], dtype=boxes.dtype, device=boxes.device)
    for l, h in zip(lo, hi):
        area = area * (h - l + pixel_offset)
    return area


def pairwise_iou(boxes1, boxes2, pixel_offset: float = 0.0):
    """IoU matrix between two box sets: (..., N, 2*dim), (..., M, 2*dim) ->
    (..., N, M), leading dims broadcast (anchors (A, 2*dim) against a batch
    of GTs (b, G, 2*dim) gives (b, A, G)).

    Degenerate boxes give IoU 0 via the max(., 0) clamps; a 0/0 union is
    guarded to avoid NaN (``boxes.py:54-73``).
    """
    lo1, hi1 = _split_corners(boxes1)
    lo2, hi2 = _split_corners(boxes2)
    inter = None
    for l1, h1, l2, h2 in zip(lo1, hi1, lo2, hi2):
        seg = torch.clamp_min(
            torch.minimum(h1[..., :, None], h2[..., None, :]) - torch.maximum(l1[..., :, None], l2[..., None, :])
            + pixel_offset,
            0.0,
        )
        inter = seg if inter is None else inter * seg
    area1 = box_area(boxes1, pixel_offset)
    area2 = box_area(boxes2, pixel_offset)
    union = area1[..., :, None] + area2[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(union))


def apply_box_deltas(boxes, deltas):
    """Decode (dy, dx, (dz), log dh, log dw, (log dd)) deltas onto boxes.

    center += delta * size; size *= exp(log-delta). Output order
    (y1, x1, y2, x2, (z1, z2)); any leading dims (``boxes.py:76-102``).
    """
    dim = box_dim(boxes)
    lo, hi = _split_corners(boxes)
    new_lo, new_hi = [], []
    for ax in range(dim):
        size = hi[ax] - lo[ax]
        center = lo[ax] + 0.5 * size
        center = center + deltas[..., ax] * size
        size = size * torch.exp(deltas[..., dim + ax])
        l = center - 0.5 * size
        new_lo.append(l)
        new_hi.append(l + size)
    cols = [new_lo[0], new_lo[1], new_hi[0], new_hi[1]]
    if dim == 3:
        cols += [new_lo[2], new_hi[2]]
    return torch.stack(cols, dim=-1)


def box_refinement(boxes, gt_boxes):
    """Encode the delta taking ``boxes`` onto ``gt_boxes``; inverse of
    ``apply_box_deltas`` (``boxes.py:105-123``)."""
    dim = box_dim(boxes)
    lo, hi = _split_corners(boxes)
    glo, ghi = _split_corners(gt_boxes)
    centers, logs = [], []
    for ax in range(dim):
        size = hi[ax] - lo[ax]
        center = lo[ax] + 0.5 * size
        gsize = ghi[ax] - glo[ax]
        gcenter = glo[ax] + 0.5 * gsize
        centers.append((gcenter - center) / size)
        logs.append(torch.log(gsize / size))
    return torch.stack(centers + logs, dim=-1)


def clip_boxes(boxes, window):
    """Clip box corners to a window (y1, x1, y2, x2, (z1, z2))
    (``boxes.py:126-143``)."""
    window = torch.as_tensor(window, dtype=boxes.dtype, device=boxes.device)
    dim = box_dim(boxes)
    cols = [
        torch.clamp(boxes[..., 0], window[0], window[2]),
        torch.clamp(boxes[..., 1], window[1], window[3]),
        torch.clamp(boxes[..., 2], window[0], window[2]),
        torch.clamp(boxes[..., 3], window[1], window[3]),
    ]
    if dim == 3:
        cols.append(torch.clamp(boxes[..., 4], window[4], window[5]))
        cols.append(torch.clamp(boxes[..., 5], window[4], window[5]))
    return torch.stack(cols, dim=-1)


def clip_boxes_to_shape(boxes, shape):
    """Clip boxes to an image shape (y, x, (z)), per axis (``boxes.py:146-160``)."""
    if box_dim(boxes) == 2:
        window = (0.0, 0.0, float(shape[0]), float(shape[1]))
    else:
        window = (0.0, 0.0, float(shape[0]), float(shape[1]), 0.0, float(shape[2]))
    return clip_boxes(boxes, window)


def normalize_boxes(boxes, image_shape):
    """Pixel -> normalized [0, 1] coords (divide each axis by its extent)."""
    return boxes / _shape_scale(boxes, image_shape)


def denormalize_boxes(boxes, image_shape):
    """Normalized [0, 1] -> pixel coords."""
    return boxes * _shape_scale(boxes, image_shape)


def _shape_scale(boxes, image_shape):
    s = [image_shape[0], image_shape[1]] * 2
    if box_dim(boxes) == 3:
        s += [image_shape[2]] * 2
    return torch.as_tensor(s, dtype=boxes.dtype, device=boxes.device)
