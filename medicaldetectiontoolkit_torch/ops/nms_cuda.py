"""Build, binding and launch of the hand-written CUDA NMS kernel (``csrc/nms.cu``).

Replaces ``medicaldetectiontoolkit_tpu/ops/nms_pallas.py::nms_pallas`` on the
GPU. The source is compiled at first use by ``ops/cuda_build.py`` (nvcc for
``sm_90a``, a plain C entry point) and loaded through ``ctypes``.

The wrapper takes CUDA tensors only. It validates shapes, lays the boxes out
as SoA ``(lanes, 2*dim, N)`` (``nms_pallas.py:101``), passes a lane stride of
0 for an ``expand``-ed lane axis instead of materialising copies, allocates
the outputs and, for lanes whose entries exceed the kernel's shared-memory
capacity, the global scratch with ``torch.empty``, and launches on the
current stream without synchronising. A refused launch raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes

import torch

from medicaldetectiontoolkit_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "nms.cu"

_lib = None
_capacity = {}  # (device index, dim) -> entries of one lane held in shared memory


def build():
    """Compile ``csrc/nms.cu`` unless a library for this source exists;
    returns its path."""
    return cuda_build.build(SOURCE, "mdt_nms")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.mdt_nms_launch.argtypes = [vp, ll, vp, ll, vp, ll, vp, i32, i32, i32, i32, i32, f32, f32, vp, vp, vp]
        lib.mdt_nms_launch.restype = i32
        lib.mdt_nms_capacity.argtypes = [i32]
        lib.mdt_nms_capacity.restype = i32
        lib.mdt_cuda_error_string.argtypes = [i32]
        lib.mdt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise(what, err):
    raise RuntimeError(f"NMS kernel {what} failed: {_load().mdt_cuda_error_string(err).decode()} ({err})")


def capacity(dev, dim: int) -> int:
    """Entries of one lane that the kernel keeps in shared memory on ``dev``;
    the first query on a device grants the kernel that shared memory there."""
    key = (dev.index, dim)
    if key not in _capacity:
        with torch.cuda.device(dev):
            cap = _load().mdt_nms_capacity(dim)
        if cap <= 0:
            _raise("capacity query", -cap)
        _capacity[key] = cap
    return _capacity[key]


def scratch_floats(n: int, dim: int, cap: int) -> int:
    """Floats of global scratch per lane: the SoA rows (coordinates, area,
    score, index) of the entries beyond the shared-memory capacity."""
    return (2 * dim + 3) * max(n - cap, 0)


def _lane_rows(x, dtype):
    """(L, ...) -> (base tensor, lane stride in elements); stride 0 when the
    lane axis is broadcast."""
    if x.shape[0] == 1 or x.stride(0) == 0:
        return x[0].to(dtype).contiguous(), 0
    x = x.to(dtype).contiguous()
    return x, x[0].numel()


def prepare(boxes, scores, iou_threshold, max_output: int, valid=None, pixel_offset: float = 1.0):
    """Validate the inputs and build one launch. Returns ``(keep_idx,
    keep_mask, launch_args)``; ``launch_args`` is None when there is nothing
    to compute."""
    if scores.dim() != 2 or boxes.dim() != 3 or boxes.shape[:2] != scores.shape or boxes.shape[-1] not in (4, 6):
        raise ValueError(f"expected boxes (L, N, 4|6) and scores (L, N); got {tuple(boxes.shape)}, {tuple(scores.shape)}")
    if valid is not None and valid.shape != scores.shape:
        raise ValueError(f"valid must be (L, N) = {tuple(scores.shape)}; got {tuple(valid.shape)}")
    dev = scores.device
    for name, t in (("boxes", boxes), ("scores", scores), ("valid", valid)):
        if t is not None and (t.device.type != "cuda" or t.device != dev):
            raise ValueError(f"{name} must be a CUDA tensor on {dev}; got {t.device}")
    L, N = scores.shape
    if N >= 2**31 - 2**20 or L >= 2**31:
        raise ValueError(f"lane or candidate count exceeds the kernel's int32 indexing: L={L}, N={N}")
    dim = boxes.shape[-1] // 2
    keep_idx = torch.empty((L, max_output), dtype=torch.int32, device=dev)
    keep_mask = torch.empty((L, max_output), dtype=torch.bool, device=dev)
    if L == 0 or max_output == 0:
        return keep_idx, keep_mask, None

    coords, coords_stride = _lane_rows(boxes.transpose(1, 2), torch.float32)  # SoA (L|1, 2*dim, N)
    score_rows, score_stride = _lane_rows(scores, torch.float32)
    if valid is None:
        valid_rows, valid_ptr, valid_stride = None, None, 0
    else:
        valid_rows, valid_stride = _lane_rows(valid, torch.bool)
        valid_ptr = valid_rows.data_ptr()
    cap = capacity(dev, dim)
    extra = scratch_floats(N, dim, cap)
    scratch = torch.empty((L * extra,), dtype=torch.float32, device=dev) if extra else None
    # the tensors stay referenced here until the launch is enqueued
    tensors = (coords, score_rows, valid_rows, scratch, keep_idx, keep_mask)
    args = (coords.data_ptr(), coords_stride, score_rows.data_ptr(), score_stride, valid_ptr, valid_stride,
            None if scratch is None else scratch.data_ptr(), L, N, cap, dim, max_output,
            float(iou_threshold), float(pixel_offset), keep_idx.data_ptr(), keep_mask.data_ptr())
    return keep_idx, keep_mask, (tensors, args, dev)


def launch(launch_args):
    """Enqueue the kernel on the current stream; raise if it is refused."""
    _, args, dev = launch_args
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.mdt_nms_launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise("launch", err)


def batched_nms(boxes, scores, iou_threshold, max_output: int, valid=None, pixel_offset: float = 1.0):
    """Greedy NMS over L lanes on the GPU; contract of ``ops.nms.batched_nms``.

    boxes (L, N, 4|6), scores (L, N), valid optional (L, N) bool, all CUDA
    tensors on one device. Returns keep_idx (L, max_output) int32 (-1
    padded) and keep_mask (L, max_output) bool, un-synchronised.
    """
    keep_idx, keep_mask, launch_args = prepare(boxes, scores, iou_threshold, max_output, valid, pixel_offset)
    if launch_args is not None:
        launch(launch_args)
        batched_nms.launches += 1
    return keep_idx, keep_mask


# kernel launches since the last reset; the main path's proof of use
batched_nms.launches = 0
