"""Build, binding and launch of the hand-written CUDA NMS kernel (``csrc/nms.cu``).

Replaces ``medicaldetectiontoolkit_tpu/ops/nms_pallas.py::nms_pallas`` on the
GPU. The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point and loaded through ``ctypes``. The build
happens at first use, into ``_build/`` next to the package sources (or, where
the package directory is read-only, as in an installed copy, into a per-user
directory under the system temporary directory), keyed on a hash of the
source and the flags, so a changed ``.cu`` rebuilds and importing this module
never needs a compiler.

The wrapper takes CUDA tensors only. It validates shapes, lays the boxes out
as SoA ``(lanes, 2*dim, N)`` (``nms_pallas.py:101``), passes a lane stride of
0 for an ``expand``-ed lane axis instead of materialising copies, allocates
the outputs and the per-lane active-score scratch with ``torch.empty``, and
launches on the current stream without synchronising. A refused launch
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "nms.cu"
BUILD_DIR = (
    _PKG_DIR / "_build" if os.access(_PKG_DIR, os.W_OK)
    else Path(tempfile.gettempdir()) / f"medicaldetectiontoolkit_torch_build_{os.getuid()}"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no contracted multiply-adds and IEEE division: bit-identical IoU
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile ``csrc/nms.cu`` unless a library for this source hash exists.

    Returns the library path; the compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it as ``.log``.
    """
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libmdt_nms_{key}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent process never loads a partial file
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.mdt_nms_launch.argtypes = [vp, ll, vp, ll, vp, ll, vp, i32, i32, i32, i32, f32, f32, vp, vp, vp]
        lib.mdt_nms_launch.restype = i32
        lib.mdt_cuda_error_string.argtypes = [i32]
        lib.mdt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _lane_rows(x, dtype):
    """(L, ...) -> (base tensor, lane stride in elements); stride 0 when the
    lane axis is broadcast."""
    if x.shape[0] == 1 or x.stride(0) == 0:
        return x[0].to(dtype).contiguous(), 0
    x = x.to(dtype).contiguous()
    return x, x[0].numel()


def batched_nms(boxes, scores, iou_threshold, max_output: int, valid=None, pixel_offset: float = 1.0):
    """Greedy NMS over L lanes on the GPU; contract of ``ops.nms.batched_nms``.

    boxes (L, N, 4|6), scores (L, N), valid optional (L, N) bool, all CUDA
    tensors on one device. Returns keep_idx (L, max_output) int32 (-1
    padded) and keep_mask (L, max_output) bool, un-synchronised.
    """
    if scores.dim() != 2 or boxes.dim() != 3 or boxes.shape[:2] != scores.shape or boxes.shape[-1] not in (4, 6):
        raise ValueError(f"expected boxes (L, N, 4|6) and scores (L, N); got {tuple(boxes.shape)}, {tuple(scores.shape)}")
    if valid is not None and valid.shape != scores.shape:
        raise ValueError(f"valid must be (L, N) = {tuple(scores.shape)}; got {tuple(valid.shape)}")
    dev = scores.device
    for name, t in (("boxes", boxes), ("scores", scores), ("valid", valid)):
        if t is not None and (t.device.type != "cuda" or t.device != dev):
            raise ValueError(f"{name} must be a CUDA tensor on {dev}; got {t.device}")
    L, N = scores.shape
    if N >= 2**31 or L >= 2**31:
        raise ValueError(f"lane or candidate count exceeds int32: L={L}, N={N}")
    dim = boxes.shape[-1] // 2
    keep_idx = torch.empty((L, max_output), dtype=torch.int32, device=dev)
    keep_mask = torch.empty((L, max_output), dtype=torch.bool, device=dev)
    if L == 0 or max_output == 0:
        return keep_idx, keep_mask

    coords, coords_stride = _lane_rows(boxes.transpose(1, 2), torch.float32)  # SoA (L|1, 2*dim, N)
    score_rows, score_stride = _lane_rows(scores, torch.float32)
    if valid is None:
        valid_rows, valid_ptr, valid_stride = None, None, 0
    else:
        valid_rows, valid_stride = _lane_rows(valid, torch.bool)
        valid_ptr = valid_rows.data_ptr()
    active = torch.empty((L, N), dtype=torch.float32, device=dev)

    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mdt_nms_launch(
            coords.data_ptr(), coords_stride, score_rows.data_ptr(), score_stride,
            valid_ptr, valid_stride, active.data_ptr(), L, N, dim, max_output,
            float(iou_threshold), float(pixel_offset), keep_idx.data_ptr(), keep_mask.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: {lib.mdt_cuda_error_string(err).decode()} ({err})")
    batched_nms.launches += 1
    return keep_idx, keep_mask


# kernel launches since the last reset; the main path's proof of use
batched_nms.launches = 0
