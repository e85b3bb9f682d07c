"""Build, binding and launch of the hand-written CUDA pyramid RoIAlign kernel
(``csrc/roi_align.cu``, kernel K2).

Replaces ``medicaldetectiontoolkit_tpu/ops/roi_align_pallas.py::
pyramid_roi_align_pallas`` on the GPU. The source is compiled at first use by
``ops/cuda_build.py`` (nvcc for ``sm_90a``, a plain C entry point) and loaded
through ``ctypes``.

The wrapper takes CUDA tensors only. ``prepare`` computes each RoI's per-axis
``(idx0, idx1, lerp)`` rows on its assigned level with the plain version's
helper (``ops/roi_align.py::_level_axis_indices``), on the device, passes
every level as one pointer plus element strides (the maps are read in place,
in any layout: no stacked or channels-last copy) and allocates the float32
output ``(R, C, *crop)`` with ``torch.empty``; ``launch`` enqueues the
kernel on the current stream without synchronising. A refused launch raises; there is no fallback.
``box_indices`` must lie in ``[0, B)``: the kernel does not check them. A
``levels_idx`` outside ``[0, len(feature_maps))`` pools zeros, as in the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from medicaldetectiontoolkit_torch.ops import cuda_build
from medicaldetectiontoolkit_torch.ops.roi_align import _AXIS_COLS, _level_axis_indices

SOURCE = cuda_build.CSRC / "roi_align.cu"
MAX_LEVELS = 8  # kMaxLevels in the source
MAX_OUTPUTS = 2**30  # kMaxOutputs in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib = None


class _Level(ctypes.Structure):
    """Mirror of ``struct Level`` in ``csrc/roi_align.cu``."""

    _fields_ = [("data", ctypes.c_void_p)] + [(f"s{ax}", ctypes.c_longlong) for ax in "bcyxz"]


def build():
    """Compile ``csrc/roi_align.cu`` unless a library for this source exists;
    returns its path."""
    return cuda_build.build(SOURCE, "mdt_roi_align")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mdt_roi_align_launch.argtypes = [vp, i32, i32, i32] + [vp] * 11 + [i32] * 5 + [vp, vp]
        lib.mdt_roi_align_launch.restype = i32
        lib.mdt_roi_align_error_string.argtypes = [i32]
        lib.mdt_roi_align_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def prepare(feature_maps, boxes, box_indices, levels_idx, crop_size):
    """Validate the inputs and build one launch: the per-axis index and
    weight rows on each RoI's level (PyTorch ops on the device), the level
    descriptors, and the float32 output ``(R, C, *crop_size)``. Returns
    ``(out, launch_args)``; ``launch_args`` is None when there is nothing to
    compute."""
    dim = len(crop_size)
    if dim not in (2, 3):
        raise ValueError(f"crop_size must be rank 2 or 3, got {crop_size}")
    if not 1 <= len(feature_maps) <= MAX_LEVELS:
        raise ValueError(f"expected 1 to {MAX_LEVELS} pyramid levels, got {len(feature_maps)}")
    f0 = feature_maps[0]
    dev, dtype = f0.device, f0.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"feature maps must be float32, bfloat16 or float16; got {dtype}")
    B, C = f0.shape[:2]
    for fm in feature_maps:
        if fm.device.type != "cuda" or fm.device != dev or fm.dtype != dtype or fm.dim() != dim + 2 \
                or tuple(fm.shape[:2]) != (B, C):
            raise ValueError(f"feature maps must be (B, C, *spatial) CUDA tensors of one dtype on {dev}, "
                             f"(B, C) = {(B, C)}; got {fm.dtype} {tuple(fm.shape)} on {fm.device}")
    R = boxes.shape[0]
    if boxes.dim() != 2 or boxes.shape[1] != 2 * dim or box_indices.shape != (R,) or levels_idx.shape != (R,):
        raise ValueError(f"expected boxes (R, {2 * dim}), box_indices and levels_idx (R,); got "
                         f"{tuple(boxes.shape)}, {tuple(box_indices.shape)}, {tuple(levels_idx.shape)}")
    for name, t in (("boxes", boxes), ("box_indices", box_indices), ("levels_idx", levels_idx)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}; got {t.device}")
    out = torch.empty((R, C, *crop_size), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, None
    if out.numel() >= MAX_OUTPUTS:
        raise ValueError(f"{out.numel()} output elements; the kernel indexes at most {MAX_OUTPUTS - 1}")

    levels_idx = levels_idx.to(torch.int32).contiguous()
    rows = []
    for ax, ((lo, hi), crop) in enumerate(zip(_AXIS_COLS, crop_size)):
        sizes = [fm.shape[2 + ax] for fm in feature_maps]
        rows += [t.contiguous() for t in _level_axis_indices(boxes, levels_idx, crop, sizes, lo, hi)]
    if dim == 2:
        rows += [None] * 3
    box_indices = box_indices.to(torch.int32).contiguous()
    levels = (_Level * len(feature_maps))()
    for k, fm in enumerate(feature_maps):
        levels[k] = _Level(fm.data_ptr(), *fm.stride(), *([0] if dim == 2 else []))
    # the tensors stay referenced here until the launch is enqueued
    tensors = (feature_maps, levels_idx, box_indices, rows, out)
    return out, (tensors, levels, len(feature_maps), _DTYPES[dtype], dim,
                 [levels_idx.data_ptr(), box_indices.data_ptr()] + [None if t is None else t.data_ptr() for t in rows],
                 [R, C, *crop_size, *([1] if dim == 2 else [])], out.data_ptr(), dev)


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
