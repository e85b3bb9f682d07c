"""RoIAlign (TF-style crop_and_resize), 2D bilinear + 3D trilinear (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/ops/roi_align.py`` and of the
plain half of ``ops/roi_align_pallas.py``, with the same float32 numerics:

  * per-axis source coordinate of output cell ``i`` of ``crop > 1`` cells:
    ``lo * S + i * scale + scale / 2 - 0.5`` with ``scale = (hi - lo) * S /
    crop``; for ``crop == 1`` the box centre ``0.5 * (lo + hi) * S``; the
    coordinate (not the index) is clamped to ``[0, S - 1]``;
  * floor/+1-clamped neighbours and one lerp per axis, in the order y, then
    x, then z (``roi_align.py:89-95``, ``:110-127``). ``roi_axes`` gives the
    indices and weights, ``roi_lerp`` the lerps after the rows are gathered,
    so a caller can gather the rows itself (the mask targets of
    ``models/mrcnn.py`` from a Y slab).

Maps are the port's channel-first ``(B, C, H, W, (Z))``; crops come out
channel-first ``(R, C, *crop)``, the layout the two-stage heads' convs take.
Boxes are normalised ``(y1, x1, y2, x2, (z1, z2))`` in [0, 1].

``pyramid_roi_align`` is the plain version of the pyramid kernel K2: it
crops every RoI from every level and keeps the assigned level's crop
(``roi_align_pallas.py:65-73``); ``pyramid_roi_align_backward_plain`` the
plain version of K2's backward, the autograd of that forward (JAX's custom
VJP, ``roi_align_pallas.py:269-285``). ``PyramidRoIAlign`` is the
differentiable pyramid RoIAlign, keyed on the maps' device: CPU tensors
take the plain versions, CUDA tensors the hand-written kernels
(``ops/roi_align_cuda.py``), and there is no third path. Only the maps get a
gradient; boxes and indices are constants, as JAX's ``stop_gradient``
makes them.
"""

from __future__ import annotations

import torch


def _axis_coords(lo, hi, crop: int, size: int):
    """Source coords for one axis; lo/hi (N,) normalised, returns (N, crop)."""
    if crop > 1:
        scale = (hi - lo) * size / crop
        cells = torch.arange(crop, dtype=lo.dtype, device=lo.device)
        coords = lo[:, None] * size + cells[None, :] * scale[:, None] + scale[:, None] / 2 - 0.5
    else:
        coords = (0.5 * (lo + hi) * size)[:, None]
    return torch.clamp(coords, 0.0, float(size - 1))


def _lerp_weights(coords, size: int):
    """floor index, +1-clamped index (int32) and lerp weight for linear interp."""
    idx0 = torch.floor(coords)
    lerp = coords - idx0
    idx0 = idx0.to(torch.int32)
    idx1 = torch.clamp_max(idx0 + 1, size - 1)
    return idx0, idx1, lerp


# (lo, hi) box columns of each axis in the (y1, x1, y2, x2, z1, z2) layout
_AXIS_COLS = ((0, 2), (1, 3), (4, 5))


def roi_axes(boxes, crop_size, sizes):
    """Per axis (y, x, (z)) of the crops of ``boxes`` (N, 2d) normalised:
    the floor index and the +1-clamped index (int32, (N, crop)) and the lerp
    weight (float32), from the whole map's extents ``sizes``."""
    boxes = boxes.to(torch.float32)
    return [_lerp_weights(_axis_coords(boxes[:, lo], boxes[:, hi], crop, int(size)), int(size))
            for (lo, hi), crop, size in zip(_AXIS_COLS, crop_size, sizes)]


def roi_lerp(top, bottom, axes, crop_size):
    """The lerps of ``roi_align`` after its y-gather: ``top`` / ``bottom``
    (N, ch, W, (Z,) C) are the map's rows ``axes[0][0]`` / ``axes[0][1]`` of
    each crop, channel-last; ``axes`` is ``roi_axes``'. Lerps y, then x,
    then z; returns (N, C, *crop_size)."""
    dim = len(crop_size)
    n = top.shape[0]
    dev = top.device
    (_, _, ly), (x0, x1, lx) = axes[0], axes[1]
    tail = (None,) * dim  # (W, (Z,) C) after the y-gather
    w_y = ly[(...,) + tail]
    out = top * (1 - w_y) + bottom * w_y  # (N, ch, W, (Z,) C)
    n_ix = torch.arange(n, device=dev)[:, None, None]
    h_ix = torch.arange(crop_size[0], device=dev)[None, :, None]
    w_x = lx[(slice(None), None, slice(None)) + tail[1:]]
    out = out[n_ix, h_ix, x0.long()[:, None, :]] * (1 - w_x) + out[n_ix, h_ix, x1.long()[:, None, :]] * w_x
    if dim == 3:
        z0, z1, lz = axes[2]
        n_ix3 = torch.arange(n, device=dev)[:, None, None, None]
        h_ix3 = torch.arange(crop_size[0], device=dev)[None, :, None, None]
        w_ix3 = torch.arange(crop_size[1], device=dev)[None, None, :, None]
        w_z = lz[:, None, None, :, None]
        front = out[n_ix3, h_ix3, w_ix3, z0.long()[:, None, None, :]]
        back = out[n_ix3, h_ix3, w_ix3, z1.long()[:, None, None, :]]
        out = front * (1 - w_z) + back * w_z
    return out.movedim(-1, 1)  # (N, C, *crop)


def roi_align(image, boxes, box_indices, crop_size):
    """Crop-and-resize RoIs out of one feature map: the rows each crop reads
    gathered (``roi_axes``), then lerped (``roi_lerp``).

    image (B, C, H, W) or (B, C, H, W, Z), any float dtype; boxes (N, 4|6)
    normalised; box_indices (N,) batch element of each box; crop_size
    (ch, cw) or (ch, cw, cz). Returns (N, C, *crop_size) in the promoted
    dtype of the image and float32 (float32 for bf16/f16 maps, as JAX).
    """
    dim = len(crop_size)
    if dim not in (2, 3) or image.dim() != dim + 2:
        raise ValueError(f"crop_size {crop_size} does not fit a map of shape {tuple(image.shape)}")
    axes = roi_axes(boxes, crop_size, image.shape[2:])
    # a channel-last view, so the gathers are those of the JAX code
    img = image.movedim(1, -1)
    b_ix = box_indices.long()[:, None]
    y0, y1, _ = axes[0]
    return roi_lerp(img[b_ix, y0.long()], img[b_ix, y1.long()], axes, crop_size)


def _level_axis_indices(boxes, levels_idx, crop: int, sizes, lo_col: int, hi_col: int):
    """floor/ceil indices and lerp weights on each RoI's assigned level
    (``roi_align_pallas.py:44-62``).

    boxes (R, 2*dim) normalised; levels_idx (R,) int; sizes: the levels'
    extents along this axis. Returns idx0, idx1 int32 (R, crop) and lerp
    float32 (R, crop).
    """
    lo, hi = boxes[:, lo_col].to(torch.float32), boxes[:, hi_col].to(torch.float32)
    idx0 = torch.zeros((boxes.shape[0], crop), dtype=torch.int32, device=boxes.device)
    idx1 = torch.zeros_like(idx0)
    lerp = torch.zeros((boxes.shape[0], crop), dtype=torch.float32, device=boxes.device)
    for lvl, size in enumerate(sizes):
        i0, i1, lw = _lerp_weights(_axis_coords(lo, hi, crop, int(size)), int(size))
        sel = (levels_idx == lvl)[:, None]
        idx0 = torch.where(sel, i0, idx0)
        idx1 = torch.where(sel, i1, idx1)
        lerp = torch.where(sel, lw, lerp)
    return idx0, idx1, lerp


def pyramid_roi_align(feature_maps, boxes, box_indices, levels_idx, crop_size):
    """Level-routed RoIAlign over an FPN pyramid, plain PyTorch: every RoI is
    cropped from every level and the assigned level's crop kept
    (``pyramid_roi_align_xla``).

    feature_maps: sequence of (B, C, *spatial_l), one dtype; boxes (R, 2*dim)
    normalised; box_indices, levels_idx (R,) int. Returns (R, C, *crop_size)
    float32 (bf16/f16 maps are promoted, as in JAX).
    """
    pooled = None
    for lvl, fmap in enumerate(feature_maps):
        crop = roi_align(fmap, boxes, box_indices, crop_size)
        sel = (levels_idx == lvl).reshape((-1,) + (1,) * (crop.dim() - 1))
        masked = torch.where(sel, crop, torch.zeros((), dtype=crop.dtype, device=crop.device))
        pooled = masked if pooled is None else pooled + masked
    return pooled.to(torch.float32)


def pyramid_roi_align_backward_plain(grad_out, feature_maps, boxes, box_indices, levels_idx, crop_size):
    """The gradient of ``pyramid_roi_align`` to the maps, plain PyTorch: the
    autograd of the plain forward, recomputed. grad_out (R, C, *crop_size)
    float32. Returns one gradient per level in the maps' dtype; bf16 and f16
    maps accumulate in their own dtype, as JAX's scatter-add does."""
    with torch.enable_grad():
        maps = [fm.detach().requires_grad_() for fm in feature_maps]
        out = pyramid_roi_align(maps, boxes, box_indices, levels_idx, crop_size)
        return list(torch.autograd.grad(out, maps, grad_out))


class PyramidRoIAlign(torch.autograd.Function):
    """Differentiable pyramid RoIAlign: ``apply(*feature_maps, boxes,
    box_indices, levels_idx, crop_size)``, the contract of
    ``pyramid_roi_align``. Forward and backward are K2 and its backward on
    CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, *args):
        *feature_maps, boxes, box_indices, levels_idx, crop_size = args
        device = feature_maps[0].device
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no pyramid RoIAlign implementation for device {device}")
        ctx.crop_size = tuple(crop_size)
        ctx.meta = [(tuple(fm.shape), fm.dtype) for fm in feature_maps]
        if device.type == "cpu":
            # the plain backward recomputes the forward from the maps
            ctx.save_for_backward(boxes, box_indices, levels_idx, *feature_maps)
            return pyramid_roi_align(feature_maps, boxes, box_indices, levels_idx, crop_size)
        from medicaldetectiontoolkit_torch.ops import roi_align_cuda

        ctx.save_for_backward(boxes, box_indices, levels_idx)
        return roi_align_cuda.pyramid_roi_align(feature_maps, boxes, box_indices, levels_idx, crop_size)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, box_indices, levels_idx, *feature_maps = ctx.saved_tensors
        if grad_out.device.type == "cpu":
            grads = pyramid_roi_align_backward_plain(grad_out, feature_maps, boxes, box_indices, levels_idx,
                                                     ctx.crop_size)
        else:
            from medicaldetectiontoolkit_torch.ops import roi_align_cuda

            grads = roi_align_cuda.pyramid_roi_align_backward(grad_out, ctx.meta, boxes, box_indices, levels_idx,
                                                              ctx.crop_size)
        return (*grads, None, None, None, None)


def pyramid_roi_align_auto(feature_maps, boxes, box_indices, levels_idx, crop_size):
    """Pyramid RoIAlign keyed on the maps' device, differentiable to the
    maps (``PyramidRoIAlign``).

    CPU tensors take the plain versions; CUDA tensors launch the
    hand-written kernels (``ops/roi_align_cuda.py``), which raise rather
    than falling back when they cannot build or launch.
    """
    return PyramidRoIAlign.apply(*feature_maps, boxes, box_indices, levels_idx, tuple(crop_size))
