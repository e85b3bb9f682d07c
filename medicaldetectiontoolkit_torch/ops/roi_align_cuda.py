"""Build, binding and launch of the hand-written CUDA pyramid RoIAlign kernel
(``csrc/roi_align.cu``, kernel K2), and a float32 model of its row
arithmetic.

Replaces ``medicaldetectiontoolkit_tpu/ops/roi_align_pallas.py::
pyramid_roi_align_pallas`` on the GPU. The source is compiled at first use by
``ops/cuda_build.py`` (nvcc for ``sm_90a``, a plain C entry point) and loaded
through ``ctypes``.

The kernel takes the inputs of the TPU kernel's function: the maps, each
level as one pointer, its extents and its element strides (read in place, in
any layout: no stacked or channels-last copy), the normalised boxes, the
batch and level index of each RoI, and the crop size. One block per RoI
computes the RoI's per-axis ``(idx0, idx1, lerp)`` rows on its level in the
plain version's float32 steps, copies the map voxels its corners need into
shared memory and evaluates the outputs from there in the plain version's
association, so its output is bit-identical to ``ops/roi_align.py::
pyramid_roi_align`` on the card. It is bound by that evaluation (8 shared
loads and 21 float operations per output) and then by the slab's gather from
device memory, against a whole-card bound of the float32 output written once
(see the source's note).

The wrapper takes CUDA tensors only. ``prepare`` validates the inputs,
allocates the float32 output ``(R, C, *crop)`` with ``torch.empty`` and
packs the level descriptors: no PyTorch op per level or axis; ``launch``
enqueues the kernel on the current stream without synchronising. A refused
launch raises; there is no fallback. ``box_indices`` must lie in ``[0, B)``:
the kernel does not check them. A ``levels_idx`` outside
``[0, len(feature_maps))`` pools zeros, as in the plain version.

``pyramid_roi_align_backward`` launches K2's backward from the same source:
one thread per element of ``grad_out`` scatters it into float32 gradients of
the levels with atomic adds (see the source's note), which are then cast to
the maps' dtype. Its float32 sums are not deterministic in their last bits.

``axis_rows`` and ``level_axis_rows`` model the kernel's row arithmetic in
numpy float32, step by step; the CPU tests hold them against
``_level_axis_indices`` and JAX's.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from medicaldetectiontoolkit_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "roi_align.cu"
MAX_LEVELS = 8  # kMaxLevels in the source
MAX_OUTPUTS = 2**30  # kMaxOutputs in the source
MAX_CROP = 64  # kMaxCrop: cells per crop axis
SLAB_FLOATS = 10240  # kSlabFloats: shared-memory slab of one block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# How the kernel forms scale = (hi - lo) * S / crop: as a product with the
# float32 reciprocal of crop, because that is what the plain version computes
# on the card (ATen's CUDA true division by a Python number multiplies by its
# reciprocal); on the CPU, and in JAX, it divides.
SCALE_BY_RECIPROCAL = True

_lib = None


class _Level(ctypes.Structure):
    """Mirror of ``struct Level`` in ``csrc/roi_align.cu``."""

    _fields_ = [("data", ctypes.c_void_p), ("sb", ctypes.c_longlong), ("sc", ctypes.c_longlong),
                ("size", ctypes.c_int * 3), ("stride", ctypes.c_int * 3)]


class _BwdLevel(ctypes.Structure):
    """Mirror of ``struct BwdLevel`` in ``csrc/roi_align.cu``."""

    _fields_ = [("offset", ctypes.c_longlong), ("size", ctypes.c_int * 3)]


def axis_rows(lo, hi, crop: int, size: int, reciprocal: bool = SCALE_BY_RECIPROCAL):
    """The kernel's rows of one axis on a level of extent ``size``, in numpy
    float32, one operation per step as the source rounds it: lo, hi (N,)
    normalised box edges. Returns idx0, idx1 int32 (N, crop) and lerp float32
    (N, crop). ``reciprocal`` selects the card's form of ``scale``
    (``SCALE_BY_RECIPROCAL``); False gives the CPU's division."""
    f32 = np.float32
    lo, hi = np.asarray(lo, f32), np.asarray(hi, f32)
    s = f32(size)
    if crop > 1:
        span = (hi - lo) * s
        scale = span * (f32(1.0) / f32(crop)) if reciprocal else span / f32(crop)
        cells = np.arange(crop, dtype=f32)
        coord = ((lo[:, None] * s + cells[None, :] * scale[:, None]) + scale[:, None] * f32(0.5)) - f32(0.5)
    else:
        coord = ((f32(0.5) * (lo + hi)) * s)[:, None]
    coord = np.minimum(np.maximum(coord, f32(0.0)), f32(size - 1))
    floor = np.floor(coord)
    idx0 = floor.astype(np.int32)
    return idx0, np.minimum(idx0 + 1, size - 1).astype(np.int32), coord - floor


def level_axis_rows(boxes, levels_idx, crop: int, sizes, lo_col: int, hi_col: int,
                    reciprocal: bool = SCALE_BY_RECIPROCAL):
    """``axis_rows`` of each RoI on its own level (numpy): boxes (R, 2*dim),
    levels_idx (R,), sizes the levels' extents along the axis. The contract of
    ``ops/roi_align.py::_level_axis_indices``: zeros for a level outside
    ``[0, len(sizes))``."""
    boxes, levels_idx = np.asarray(boxes, np.float32), np.asarray(levels_idx)
    R = boxes.shape[0]
    idx0, idx1 = np.zeros((R, crop), np.int32), np.zeros((R, crop), np.int32)
    lerp = np.zeros((R, crop), np.float32)
    for lvl, size in enumerate(sizes):
        sel = levels_idx == lvl
        idx0[sel], idx1[sel], lerp[sel] = axis_rows(boxes[sel, lo_col], boxes[sel, hi_col], crop, int(size),
                                                    reciprocal)
    return idx0, idx1, lerp


def build():
    """Compile ``csrc/roi_align.cu`` unless a library for this source exists;
    returns its path."""
    return cuda_build.build(SOURCE, "mdt_roi_align")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mdt_roi_align_launch.argtypes = [vp, i32, i32, i32, vp, vp, vp] + [i32] * 5 + [vp, vp]
        lib.mdt_roi_align_launch.restype = i32
        lib.mdt_roi_align_bwd_launch.argtypes = [vp, i32, i32, vp, vp, vp] + [i32] * 5 + [vp, vp,
                                                                                      ctypes.c_longlong, vp]
        lib.mdt_roi_align_bwd_launch.restype = i32
        lib.mdt_roi_align_error_string.argtypes = [i32]
        lib.mdt_roi_align_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_rois(boxes, box_indices, levels_idx, dim: int, dev):
    """The RoIs' shapes and device; returns R."""
    R = boxes.shape[0]
    if boxes.dim() != 2 or boxes.shape[1] != 2 * dim or box_indices.shape != (R,) or levels_idx.shape != (R,):
        raise ValueError(f"expected boxes (R, {2 * dim}), box_indices and levels_idx (R,); got "
                         f"{tuple(boxes.shape)}, {tuple(box_indices.shape)}, {tuple(levels_idx.shape)}")
    for name, t in (("boxes", boxes), ("box_indices", box_indices), ("levels_idx", levels_idx)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}; got {t.device}")
    return R


def prepare(feature_maps, boxes, box_indices, levels_idx, crop_size):
    """Validate the inputs and build one launch: the level descriptors
    (pointer, extents, strides) and the float32 output ``(R, C,
    *crop_size)``. Returns ``(out, launch_args)``; ``launch_args`` is None
    when there is nothing to compute."""
    dim = len(crop_size)
    if dim not in (2, 3):
        raise ValueError(f"crop_size must be rank 2 or 3, got {crop_size}")
    ch, cw, cz = (*crop_size, 1)[:3]
    slab = 2 * ch * (2 * cw * (2 * cz + 1) if dim == 3 else 2 * cw + 1)
    if not all(1 <= c <= MAX_CROP for c in crop_size) or slab > SLAB_FLOATS:
        raise ValueError(f"crop_size {tuple(crop_size)}: the kernel takes 1 to {MAX_CROP} cells per axis and a "
                         f"slab of at most {SLAB_FLOATS} floats per channel (this crop's largest: {slab})")
    if not 1 <= len(feature_maps) <= MAX_LEVELS:
        raise ValueError(f"expected 1 to {MAX_LEVELS} pyramid levels, got {len(feature_maps)}")
    f0 = feature_maps[0]
    dev, dtype = f0.device, f0.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"feature maps must be float32, bfloat16 or float16; got {dtype}")
    B, C = f0.shape[:2]
    for fm in feature_maps:
        if fm.device.type != "cuda" or fm.device != dev or fm.dtype != dtype or fm.dim() != dim + 2 \
                or tuple(fm.shape[:2]) != (B, C) or min(fm.shape[2:]) < 1:
            raise ValueError(f"feature maps must be (B, C, *spatial) CUDA tensors of one dtype on {dev}, "
                             f"(B, C) = {(B, C)}, spatial extents >= 1; got {fm.dtype} {tuple(fm.shape)} on "
                             f"{fm.device}")
    R = _check_rois(boxes, box_indices, levels_idx, dim, dev)
    out = torch.empty((R, C, *crop_size), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, None
    if out.numel() >= MAX_OUTPUTS:
        raise ValueError(f"{out.numel()} output elements; the kernel indexes at most {MAX_OUTPUTS - 1}")

    levels = (_Level * len(feature_maps))()
    for k, fm in enumerate(feature_maps):
        # (H, W, Z) extents and strides; 2D has Z = 1, and an axis of extent
        # 1 gets stride 0 (its only index is 0)
        sizes = (*fm.shape[2:], 1, 1)[:3]
        strides = [st if n > 1 else 0 for n, st in zip(sizes, (*fm.stride()[2:], 0))]
        if sum((n - 1) * st for n, st in zip(sizes, strides)) >= 2**31:
            raise ValueError(f"level {k}: in-plane offsets of {tuple(fm.shape)} strides {fm.stride()} exceed int32")
        levels[k] = _Level(fm.data_ptr(), fm.stride(0), fm.stride(1), (ctypes.c_int * 3)(*sizes),
                           (ctypes.c_int * 3)(*strides))
    boxes = boxes.to(torch.float32).contiguous()
    box_indices = box_indices.to(torch.int32).contiguous()
    levels_idx = levels_idx.to(torch.int32).contiguous()
    # the tensors stay referenced here until the launch is enqueued
    tensors = (feature_maps, boxes, box_indices, levels_idx, out)
    return out, (tensors, levels, len(feature_maps), _DTYPES[dtype], dim,
                 [boxes.data_ptr(), box_indices.data_ptr(), levels_idx.data_ptr()],
                 [R, C, ch, cw, cz], out.data_ptr(), dev)


def launch(launch_args):
    """Enqueue the kernel on the current stream; raise if it is refused."""
    _, levels, n_levels, dtype_code, dim, ptrs, sizes, out_ptr, dev = launch_args
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mdt_roi_align_launch(levels, n_levels, dtype_code, dim, *ptrs, *sizes, out_ptr, stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign kernel launch failed: {lib.mdt_roi_align_error_string(err).decode()} ({err})")


def pyramid_roi_align(feature_maps, boxes, box_indices, levels_idx, crop_size):
    """Level-routed RoIAlign on the GPU; contract of
    ``ops.roi_align.pyramid_roi_align``.

    feature_maps: sequence of (B, C, *spatial_l) CUDA tensors of one float
    dtype (float32, bfloat16 or float16) on one device; boxes (R, 2*dim)
    normalised; box_indices, levels_idx (R,) int. Returns (R, C, *crop_size)
    float32, un-synchronised.
    """
    out, launch_args = prepare(feature_maps, boxes, box_indices, levels_idx, crop_size)
    if launch_args is not None:
        launch(launch_args)
        pyramid_roi_align.launches += 1
    return out


# kernel launches since the last reset; the main path's proof of use
pyramid_roi_align.launches = 0


def prepare_backward(grad_out, feature_maps_meta, boxes, box_indices, levels_idx, crop_size):
    """Validate the backward's inputs and build one launch: the level
    descriptors and the float32 gradient buffer of all levels. Returns
    ``(buffer, shapes, launch_args)``; ``launch_args`` is None when
    ``grad_out`` is empty (the gradients are then zeros)."""
    dim = len(crop_size)
    if dim not in (2, 3) or not all(1 <= c for c in crop_size):
        raise ValueError(f"crop_size must be rank 2 or 3 with cells >= 1, got {crop_size}")
    if not 1 <= len(feature_maps_meta) <= MAX_LEVELS:
        raise ValueError(f"expected 1 to {MAX_LEVELS} pyramid levels, got {len(feature_maps_meta)}")
    shapes = [tuple(int(n) for n in shape) for shape, _ in feature_maps_meta]
    dtypes = [d for _, d in feature_maps_meta]
    B, C = shapes[0][:2]
    if dtypes[0] not in _DTYPES or any(d != dtypes[0] for d in dtypes) or \
            any(len(s) != dim + 2 or s[:2] != (B, C) or min(s[2:]) < 1 for s in shapes):
        raise ValueError(f"feature maps must be (B, C, *spatial) of one dtype (float32, bfloat16 or float16); got "
                         f"{list(zip(shapes, dtypes))}")
    R = boxes.shape[0]
    dev = grad_out.device
    if dev.type != "cuda" or tuple(grad_out.shape) != (R, C, *crop_size):
        raise ValueError(f"grad_out must be a CUDA tensor of shape {(R, C, *crop_size)}; got "
                         f"{tuple(grad_out.shape)} on {dev}")
    _check_rois(boxes, box_indices, levels_idx, dim, dev)
    if grad_out.numel() >= MAX_OUTPUTS:
        raise ValueError(f"{grad_out.numel()} gradient elements; the kernel indexes at most {MAX_OUTPUTS - 1}")
    sizes = [math.prod(s) for s in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    if grad_out.numel() == 0:
        buf.zero_()
        return buf, shapes, None
    levels = (_BwdLevel * len(shapes))()
    offset = 0
    for k, (shape, n) in enumerate(zip(shapes, sizes)):
        levels[k] = _BwdLevel(offset, (ctypes.c_int * 3)(*(*shape[2:], 1, 1)[:3]))
        offset += n
    grad_out = grad_out.to(torch.float32).contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    box_indices = box_indices.to(torch.int32).contiguous()
    levels_idx = levels_idx.to(torch.int32).contiguous()
    # the tensors stay referenced here until the launch is enqueued
    tensors = (grad_out, boxes, box_indices, levels_idx, buf)
    ptrs = [boxes.data_ptr(), box_indices.data_ptr(), levels_idx.data_ptr()]
    return buf, shapes, (tensors, levels, len(shapes), dim, ptrs, [R, C, *(*crop_size, 1)[:3]], grad_out.data_ptr(),
                         buf.data_ptr(), buf.numel(), dev)


def launch_backward(launch_args):
    """Enqueue the backward (zero the buffer, then the scatter) on the
    current stream; raise if it is refused."""
    _, levels, n_levels, dim, ptrs, sizes, grad_ptr, buf_ptr, buf_elems, dev = launch_args
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mdt_roi_align_bwd_launch(levels, n_levels, dim, *ptrs, *sizes, grad_ptr, buf_ptr, buf_elems,
                                           stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign backward kernel launch failed: {lib.mdt_roi_align_error_string(err).decode()} "
                           f"({err})")


def pyramid_roi_align_backward(grad_out, feature_maps_meta, boxes, box_indices, levels_idx, crop_size):
    """K2's backward on the GPU: the gradient of ``pyramid_roi_align`` to
    the maps, as ``ops.roi_align.pyramid_roi_align_backward_plain`` computes
    it, but summed in float32 whatever the maps' dtype.

    grad_out (R, C, *crop_size) CUDA tensor (made float32 and contiguous);
    feature_maps_meta: the levels' ``(shape, dtype)``, shapes (B, C,
    *spatial_l), one float dtype; boxes, box_indices, levels_idx as the
    forward's. Returns one gradient per level, contiguous, in the maps'
    dtype; un-synchronised. A RoI whose level lies outside ``[0,
    len(feature_maps_meta))`` adds nothing.
    """
    buf, shapes, launch_args = prepare_backward(grad_out, feature_maps_meta, boxes, box_indices, levels_idx,
                                                crop_size)
    if launch_args is not None:
        launch_backward(launch_args)
        pyramid_roi_align_backward.launches += 1
    grads = [g.view(s) for g, s in zip(buf.split([math.prod(s) for s in shapes]), shapes)]
    dtype = feature_maps_meta[0][1]
    return grads if dtype == torch.float32 else [g.to(dtype) for g in grads]


# kernel launches since the last reset; the main path's proof of use
pyramid_roi_align_backward.launches = 0
