"""Build, binding and launch of the hand-written CUDA stem-conv kernels
(``csrc/stem_conv.cu``): the forward K3 and the weight gradient K4.

Replace ``medicaldetectiontoolkit_tpu/ops/stem_conv_pallas.py::
_stem_pallas_fwd`` and ``::_stem_pallas_wgrad`` on the GPU. The source is
compiled at first use by ``ops/cuda_build.py`` (nvcc for ``sm_90a``, a plain
C entry point) and loaded through ``ctypes``.

The wrappers take CUDA tensors only, channel-first as the port's convs: x
``(B, cin, Y, X, Z)``, w ``(cout, cin, k, k, k)``. They check devices,
dtypes (float32 or bfloat16, one for all), shapes, ``k`` in {3, 5, 7},
``cout <= 32`` and that the kernel's shared memory fits, allocate outputs and
K4's partial sums with ``torch.empty``, and launch on the current stream
without synchronising. A refused launch raises; there is no fallback.

K4 is two launches: a persistent partial pass of ``G`` blocks (``G`` the
smaller of the number of chunks and the blocks that fit on the card at
once, which ``mdt_stem_wgrad_capacity`` reports), each summing chunks
``i, i + G, ...`` into its own float32 row of dw, then a reduce of the ``G``
rows in a fixed order. ``wgrad_grid`` and ``wgrad_chunks`` give that
schedule; ``wgrad_plan`` the one a launch takes on its card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from medicaldetectiontoolkit_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "stem_conv.cu"
KERNEL_SIZES = (3, 5, 7)
MAX_COUT = 32
SMEM_MAX = 232448  # kSmemMax in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def build():
    """Compile ``csrc/stem_conv.cu`` unless a library for this source
    exists; returns its path."""
    return cuda_build.build(SOURCE, "mdt_stem_conv")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mdt_stem_fwd_launch.argtypes = [vp] * 4 + [i32] * 10 + [vp]
        lib.mdt_stem_fwd_launch.restype = i32
        lib.mdt_stem_wgrad_launch.argtypes = [vp] * 4 + [i32] * 12 + [vp]
        lib.mdt_stem_wgrad_launch.restype = i32
        lib.mdt_stem_wgrad_capacity.argtypes = [i32] * 7
        lib.mdt_stem_wgrad_capacity.restype = i32
        lib.mdt_stem_fwd_smem.argtypes = [i32] * 3
        lib.mdt_stem_fwd_smem.restype = i32
        lib.mdt_stem_wgrad_smem.argtypes = [i32] * 7
        lib.mdt_stem_wgrad_smem.restype = i32
        lib.mdt_stem_error_string.argtypes = [i32]
        lib.mdt_stem_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, k, cout, sy, sx, **others):
    if x.dim() != 5 or x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError(f"x must be a (B, cin, Y, X, Z) float32 or bfloat16 CUDA tensor; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    for name, (t, shape) in others.items():
        if t.device != x.device or t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {x.dtype} on {x.device}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if k not in KERNEL_SIZES or not 1 <= cout <= MAX_COUT or sy not in (1, 2) or sx not in (1, 2):
        raise ValueError(f"the stem kernels take k in {KERNEL_SIZES}, cout <= {MAX_COUT} and strides 1 or 2; "
                         f"got k={k}, cout={cout}, stride=({sy}, {sx})")
    if x.numel() >= 2**31:
        raise ValueError(f"x has {x.numel()} elements; the kernels index channels with 32-bit offsets")


def _raise(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.mdt_stem_error_string(err).decode()} ({err})")


def stem_conv3d(x, w, b, sy: int, sx: int):
    """K3: SAME 3D conv, stride (sy, sx, 1), float32 accumulation, cast, then
    the bias added in x's dtype. x (B, cin, Y, X, Z), w (cout, cin, k, k, k),
    b (cout,), one dtype. Returns (B, cout, ceil(Y/sy), ceil(X/sx), Z) in x's
    dtype, un-synchronised."""
    cout, cin, k = w.shape[0], w.shape[1], w.shape[-1]
    B, _, Y, X, Z = x.shape
    _check(x, k, cout, sy, sx, w=(w, (cout, x.shape[1], k, k, k)), b=(b, (cout,)))
    lib = _load()
    smem = lib.mdt_stem_fwd_smem(cin, k, cout)
    if smem > SMEM_MAX:
        raise ValueError(f"the filter takes {smem} bytes of shared memory; a block has {SMEM_MAX}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty((B, cout, -(-Y // sy), -(-X // sx), Z), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mdt_stem_fwd_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
                                      B, cin, Y, X, Z, cout, k, sy, sx, stream)
    _raise(lib, err, "stem conv forward (K3)")
    stem_conv3d.launches += 1
    return out


def wgrad_grid(B: int, Yo: int, Xo: int, xt: int, capacity: int):
    """K4's (number of chunks, G): a chunk is (b, yo, xt columns of xo) of
    a (B, cout, Yo, Xo, Z) gradient, and G, the partial pass's grid and the
    rows of its float32 scratch, is the smaller of the chunks and
    ``capacity``, the blocks resident on the card at once."""
    n_chunks = B * Yo * -(-Xo // xt)
    return n_chunks, min(n_chunks, capacity)


def wgrad_chunks(block: int, grid: int, B: int, Yo: int, Xo: int, xt: int):
    """The chunks that block ``block`` of K4's partial pass (of ``grid``
    blocks) sums into its row, in its order, each as (b, yo, first xo): the
    chunk numbered c = (b * Yo + yo) * ceil(Xo / xt) + xo // xt, block i
    taking c = i, i + G, i + 2G, ... (the kernel's chunk loop)."""
    n_xt = -(-Xo // xt)
    return [(c // n_xt // Yo, c // n_xt % Yo, c % n_xt * xt) for c in range(block, B * Yo * n_xt, grid)]


@functools.lru_cache(maxsize=64)
def _wgrad_plan(device: int, dtype: int, B: int, cin: int, Y: int, X: int, Z: int, cout: int, k: int, sy: int,
                sx: int):
    lib = _load()
    # chunk columns: 8 unless the tiles do not fit in shared memory
    xt = next((t for t in (8, 4, 2, 1) if lib.mdt_stem_wgrad_smem(cin, X, Z, cout, k, sx, t) <= SMEM_MAX), None)
    if xt is None:
        raise ValueError(f"one column of g and x takes more than {SMEM_MAX} bytes of shared memory (Z={Z})")
    with torch.cuda.device(device):
        capacity = lib.mdt_stem_wgrad_capacity(dtype, cin, Z, cout, k, sx, xt)
    if capacity < 0:
        _raise(lib, -capacity, "stem conv weight gradient (K4) occupancy query")
    return (xt,) + wgrad_grid(B, -(-Y // sy), -(-X // sx), xt, capacity)


def wgrad_plan(x, cout: int, k: int, sy: int, sx: int):
    """K4's launch plan for x (B, cin, Y, X, Z) on its card: (xt, number of
    chunks, G), as ``wgrad_grid``. Kept per card and shape: G depends on
    nothing else, so the occupancy query runs once for each."""
    return _wgrad_plan(x.device.index, _DTYPES[x.dtype], *x.shape, cout, k, sy, sx)


def stem_wgrad(x, g, k: int, sy: int, sx: int):
    """K4: dw (cout, cin, k, k, k) float32 of the K3 conv, from x (B, cin, Y,
    X, Z) and the output gradient g (B, cout, Yo, Xo, Z) of x's dtype.
    Deterministic: a persistent grid of G blocks, block i summing chunks
    i, i + G, ... into its own row, then the G rows summed in a fixed order
    (``wgrad_plan``, ``wgrad_chunks``). The partial pass is bound by latency
    (a block's warps wait while its chunk's tiles load, with 2 or 3 blocks
    per SM); the reduce reads the G rows from L2."""
    B, cin, Y, X, Z = x.shape
    cout = g.shape[1]
    Yo, Xo = -(-Y // sy), -(-X // sx)
    _check(x, k, cout, sy, sx, g=(g, (B, cout, Yo, Xo, Z)))
    lib = _load()
    xt, _, grid = wgrad_plan(x, cout, k, sy, sx)
    x, g = x.contiguous(), g.contiguous()
    partials = torch.empty((grid, cout * cin * k**3), dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, k, k, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mdt_stem_wgrad_launch(x.data_ptr(), g.data_ptr(), partials.data_ptr(), dw.data_ptr(),
                                        _DTYPES[x.dtype], B, cin, Y, X, Z, cout, k, sy, sx, xt, grid, stream)
    _raise(lib, err, "stem conv weight gradient (K4)")
    stem_wgrad.launches += 1
    return dw


# kernel launches since the last reset; the main path's proof of use
stem_conv3d.launches = 0
stem_wgrad.launches = 0
