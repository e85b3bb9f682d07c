"""Build of the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point, loaded through ``ctypes`` by its wrapper
(``ops/nms_cuda.py``, ``ops/roi_align_cuda.py``). The build happens at first
use, into ``_build/`` next to the package sources (or, where the package
directory is read-only, as in an installed copy, into a per-user directory
under the system temporary directory), keyed on a hash of the source and the
flags, so a changed ``.cu`` rebuilds and importing a wrapper never needs a
compiler.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = (
    PKG_DIR / "_build" if os.access(PKG_DIR, os.W_OK)
    else Path(tempfile.gettempdir()) / f"medicaldetectiontoolkit_torch_build_{os.getuid()}"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no contracted multiply-adds and IEEE division: results bit-identical
    # to PyTorch's separate elementwise ops
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc() -> str:
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


def build(source: Path, name: str) -> Path:
    """Compile ``source`` into ``lib<name>_<hash>.so`` unless it exists.

    Returns the library path; the compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it as ``.log``.
    """
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{key}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent process never loads a partial file
    return lib_path
