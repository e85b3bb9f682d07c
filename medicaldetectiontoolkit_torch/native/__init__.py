"""Native (C++/OpenMP) host library of the port: augmentation resampling and
test-time consolidation.

Counterpart of ``medicaldetectiontoolkit_tpu/native/``, with its own copy of
the two sources and the same C ABI: ``resample.cpp`` (``resample_linear_f32``,
``resample_nearest_u8``, ``gaussian_f64``, ``build_coords_f64``: the training
loader's spatial augmentation) and ``wbc.cpp`` (``wbc_greedy``, ``nms_2to3d``:
the ``Predictor``'s consolidation). The Python wrappers have the JAX
package's names and contracts.

The library is built at first use (never at import) with
``g++ -O3 -march=native -fPIC -fopenmp -shared`` into the package's
``_build/`` directory, the one the CUDA kernels use. Its file name is keyed on
the sources, the flags, the compiler's version, the host's name and the
target that ``-march=native`` resolves to there, so a library built on one
machine is never loaded on another. It is written under a temporary name and
moved into place, so concurrent processes (pytest workers) never load a
partial file.

There is no silent fallback: a build that fails raises with the compiler's
output. ``MDT_NO_NATIVE=1`` (read at every call) asks for the NumPy / scipy
paths by name; then ``get_lib`` returns None, the resample wrappers run
scipy, and ``build_coords``, ``wbc_greedy`` and ``nms_2to3d`` return None for
their callers' NumPy loops.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from medicaldetectiontoolkit_torch.ops.cuda_build import BUILD_DIR

_HERE = Path(__file__).resolve().parent
SOURCES = ("resample.cpp", "wbc.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-shared")
_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None
_info = {}
_calls = {"wbc_greedy": 0, "nms_2to3d": 0}


def enabled() -> bool:
    """False when ``MDT_NO_NATIVE=1`` asks for the NumPy / scipy paths."""
    return os.environ.get("MDT_NO_NATIVE") != "1"


def _run(cmd, **kwargs):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=300, **kwargs)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native host library needs the C++ compiler {CXX!r}, which is not on PATH "
                           "(MDT_NO_NATIVE=1 runs the NumPy / scipy paths instead)") from e


def _host_target() -> str:
    """The compiler's own command line for ``-march=native`` on this host:
    the CPU model and every target feature it enables."""
    proc = _run([CXX, "-march=native", "-E", "-v", "-"], input="")
    lines = [ln.strip() for ln in proc.stderr.splitlines() if "-march=" in ln]
    if proc.returncode or not lines:
        raise RuntimeError(f"{CXX} -march=native -E -v failed ({proc.returncode}):\n{proc.stderr}")
    return lines[0]


def _compiler_version() -> str:
    return _run([CXX, "--version"]).stdout.splitlines()[0]


def library_path() -> Path:
    """This host's library file, keyed on the sources, the flags, the
    compiler's version, the host's name and ``-march=native``'s target."""
    key = hashlib.sha256()
    for src in SOURCES:
        key.update((_HERE / src).read_bytes())
    for part in (" ".join(CXX_FLAGS), _compiler_version(), platform.node(), _host_target()):
        key.update(part.encode())
    return BUILD_DIR / f"libmdt_native_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this host's copy exists; returns its path.

    The compiler's version, command and output are kept beside it as
    ``.log``."""
    version = _compiler_version()
    lib_path = library_path()
    _info.update(path=str(lib_path), compiler=version, built=False)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=lib_path.name + ".", suffix=".tmp")
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, *(str(_HERE / s) for s in SOURCES), "-o", tmp]
    t0 = time.perf_counter()
    proc = _run(cmd)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the native host library failed to build ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    lib_path.with_suffix(".log").write_text(f"{version}\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent process never loads a partial file
    _info.update(built=True, build_s=time.perf_counter() - t0)
    _log.info(f"built {lib_path.name} with {version} in {_info['build_s']:.1f} s")
    return lib_path


def _signatures(lib):
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.resample_linear_f32.argtypes = [f32p, i64p, ctypes.c_int, f64p, ctypes.c_int64, ctypes.c_float, f32p]
    lib.resample_nearest_u8.argtypes = [u8p, i64p, ctypes.c_int, f64p, ctypes.c_int64, ctypes.c_uint8, u8p]
    lib.gaussian_f64.argtypes = [f64p, i64p, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    lib.build_coords_f64.argtypes = [ctypes.c_void_p, f64p, ctypes.c_double, i64p, ctypes.c_int, f64p, f64p]
    lib.native_num_threads.argtypes = []
    lib.native_num_threads.restype = ctypes.c_int
    lib.wbc_greedy.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int32, i64p, i64p, ctypes.c_double, ctypes.c_double, f64p, f64p, i64p,
    ]
    lib.nms_2to3d.argtypes = [f64p, ctypes.c_int64, i64p, ctypes.c_double, i64p, f64p, i64p]
    for fn in (lib.resample_linear_f32, lib.resample_nearest_u8, lib.gaussian_f64, lib.build_coords_f64,
               lib.wbc_greedy, lib.nms_2to3d):
        fn.restype = None
    return lib


def get_lib():
    """The loaded library (built at first use), or None under
    ``MDT_NO_NATIVE=1``. A failed build raises."""
    global _lib
    if not enabled():
        return None
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _signatures(ctypes.CDLL(str(build())))
    return _lib


def lib_info() -> dict:
    """Where the loaded library lives, the compiler that built it, whether
    this process built it, and its OpenMP thread count (empty before the
    first ``get_lib``)."""
    if _lib is None:
        return {}
    return dict(_info, omp_threads=int(_lib.native_num_threads()))


def calls() -> dict:
    """How many times ``wbc_greedy`` and ``nms_2to3d`` ran in the library."""
    with _lock:
        return dict(_calls)


def reset_calls():
    with _lock:
        for k in _calls:
            _calls[k] = 0


def _count(name):
    with _lock:
        _calls[name] += 1


def map_coordinates_linear(src: np.ndarray, coords: np.ndarray, cval: float) -> np.ndarray:
    """scipy.ndimage.map_coordinates(order=1, mode='constant') equivalent.

    src: float array (any dtype, computed in float32); coords: (dim, *out).
    """
    lib = get_lib()
    if lib is None:
        from scipy import ndimage

        return ndimage.map_coordinates(
            src.astype(np.float64), coords, order=1, mode="constant", cval=cval
        ).astype(np.float32)
    out_shape = coords.shape[1:]
    flat = np.ascontiguousarray(coords.reshape(coords.shape[0], -1), np.float64)
    out = np.empty(flat.shape[1], np.float32)
    lib.resample_linear_f32(
        np.ascontiguousarray(src, np.float32), np.asarray(src.shape, np.int64), src.ndim,
        flat, flat.shape[1], np.float32(cval), out,
    )
    return out.reshape(out_shape)


def map_coordinates_nearest(src: np.ndarray, coords: np.ndarray, cval: int = 0) -> np.ndarray:
    """scipy.ndimage.map_coordinates(order=0, mode='constant') for uint8 seg."""
    lib = get_lib()
    if lib is None:
        from scipy import ndimage

        return ndimage.map_coordinates(src, coords, order=0, mode="constant", cval=cval)
    out_shape = coords.shape[1:]
    flat = np.ascontiguousarray(coords.reshape(coords.shape[0], -1), np.float64)
    out = np.empty(flat.shape[1], np.uint8)
    lib.resample_nearest_u8(
        np.ascontiguousarray(src, np.uint8), np.asarray(src.shape, np.int64), src.ndim,
        flat, flat.shape[1], np.uint8(cval), out,
    )
    return out.reshape(out_shape).astype(src.dtype)


def build_coords(elastic, rot, scale, patch_size, center_in):
    """Fused sampling grid: rot/scale/elastic/center in one pass, or None
    under ``MDT_NO_NATIVE=1`` (callers use the NumPy path).

    elastic: (dim, *patch) float64 displacement (already * alpha) or None;
    rot: (dim, dim); center_in: per-axis input-center offsets.
    """
    lib = get_lib()
    if lib is None:
        return None
    patch = np.asarray(patch_size, np.int64)
    dim = len(patch_size)
    out = np.empty((dim,) + tuple(patch_size), np.float64)
    e_arg = None
    if elastic is not None:
        elastic = np.ascontiguousarray(elastic, np.float64)
        e_arg = elastic.ctypes.data_as(ctypes.c_void_p)
    lib.build_coords_f64(
        e_arg, np.ascontiguousarray(rot, np.float64), float(scale),
        patch, dim, np.ascontiguousarray(center_in, np.float64), out,
    )
    return out


def gaussian_filter_constant(arr: np.ndarray, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter(mode='constant', cval=0) equivalent."""
    lib = get_lib()
    if lib is None:
        from scipy import ndimage

        return ndimage.gaussian_filter(arr, sigma, mode="constant", cval=0, truncate=truncate)
    buf = np.ascontiguousarray(arr, np.float64).copy()
    lib.gaussian_f64(buf, np.asarray(buf.shape, np.int64), buf.ndim, float(sigma), float(truncate))
    return buf.astype(arr.dtype) if arr.dtype != np.float64 else buf


def wbc_greedy(dets: np.ndarray, patch_codes: np.ndarray, order: np.ndarray, thresh: float, n_ens: float):
    """Native weighted box clustering (``predictor.weighted_box_clustering``
    semantics; the caller supplies the seed order and integer patch codes).
    Returns (keep_scores, keep_coords), or None under ``MDT_NO_NATIVE=1``."""
    lib = get_lib()
    if lib is None:
        return None
    n, cols = dets.shape
    nc = cols - 3
    keep_scores = np.empty(n, np.float64)
    keep_coords = np.empty((n, nc), np.float64)
    n_keep = np.zeros(1, np.int64)
    lib.wbc_greedy(
        np.ascontiguousarray(dets, np.float64), n, nc // 2,
        np.ascontiguousarray(patch_codes, np.int64), np.ascontiguousarray(order, np.int64),
        float(thresh), float(n_ens), keep_scores, keep_coords, n_keep,
    )
    _count("wbc_greedy")
    k = int(n_keep[0])
    return keep_scores[:k], keep_coords[:k]


def nms_2to3d(dets: np.ndarray, order: np.ndarray, thresh: float):
    """Native 2D-slice -> 3D-cube clustering (``predictor.nms_2to3D``
    semantics; the caller supplies the score order). Returns (keep_indices,
    keep_z), or None under ``MDT_NO_NATIVE=1``."""
    lib = get_lib()
    if lib is None:
        return None
    n = dets.shape[0]
    keep = np.empty(n, np.int64)
    keep_z = np.empty((n, 2), np.float64)
    n_keep = np.zeros(1, np.int64)
    lib.nms_2to3d(
        np.ascontiguousarray(dets, np.float64), n, np.ascontiguousarray(order, np.int64), float(thresh),
        keep, keep_z, n_keep,
    )
    _count("nms_2to3d")
    k = int(n_keep[0])
    return keep[:k], keep_z[:k]
