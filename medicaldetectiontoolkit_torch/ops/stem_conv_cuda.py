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

K3 is one launch over tiles of outputs (one b, ``ty`` rows of yo, ``tx``
columns of xo, ``zt`` blocks of 4 z values, every channel): a persistent
grid of ``G`` blocks (the smaller of the tiles and the blocks that fit on
the card at once, ``mdt_stem_fwd_capacity``), block i taking tiles i, i +
G, ...; it stages the filter once and each tile's zero-padded input in
shared memory, the next tile's copy in flight while it sums the current one
where two buffers fit. ``fwd_plan`` gives the tile and shared memory,
``fwd_tiles`` each tile's outputs and staged window, ``fwd_thread`` a
thread's outputs and ``fwd_block_tiles`` a block's tiles; the wrapper keeps
the plan per card and shape (``_fwd_plan``).

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
FWD_THREADS = 256  # kFwdThreads: K3's threads per block, at most
FWD_ZT = 32  # z blocks of 4 values per K3 tile, at most
SM_SMEM = 233472  # shared memory of an SM; each block also takes 1 KB
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
        lib.mdt_stem_fwd_launch.argtypes = [vp] * 4 + [i32] * 15 + [vp]
        lib.mdt_stem_fwd_launch.restype = i32
        lib.mdt_stem_fwd_capacity.argtypes = [i32] * 5
        lib.mdt_stem_fwd_capacity.restype = i32
        lib.mdt_stem_wgrad_launch.argtypes = [vp] * 4 + [i32] * 12 + [vp]
        lib.mdt_stem_wgrad_launch.restype = i32
        lib.mdt_stem_wgrad_capacity.argtypes = [i32] * 7
        lib.mdt_stem_wgrad_capacity.restype = i32
        lib.mdt_stem_fwd_smem.argtypes = [i32] * 10
        lib.mdt_stem_fwd_smem.restype = ctypes.c_longlong
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


def fwd_channels(cout: int) -> int:
    """The channels K3 accumulates for ``cout`` (``fwd_co`` in the source):
    18 exactly, else the next multiple of 8."""
    return next(c for c in (8, 16, 18, 24, 32) if cout <= c)


def fwd_plan(shape, k: int, sy: int, sx: int, cout: int, item: int = 4):
    """K3's tiles for x of ``shape`` (B, cin, Y, X, Z) whose values take
    ``item`` bytes (4 float32, 2 bfloat16): a dict of the tile (``zt``
    blocks of 4 z values, ``tx`` xo columns, ``ty`` yo rows), ``threads``
    per block, the tiles along z, xo and yo (``per_axis``) and in all
    (``n_tiles``), the staged tile's ``rows``, ``cols`` and ``nq`` groups
    of 4 values per row, the filter's ``cs`` floats per tap, ``co``
    accumulated channels, ``nbuf`` tile buffers and ``smem`` (bytes;
    ``mdt_stem_fwd_smem`` in the source). A tile holds up to 32 z blocks
    and 2 yo rows, then as many xo columns as fill 256 threads (fewer where
    one buffer would not fit in shared memory); two buffers where two blocks
    still fit on an SM, else one."""
    B, cin, Y, X, Z = shape
    Yo, Xo = -(-Y // sy), -(-X // sx)
    nzb = -(-Z // 4)
    zt, ty = min(nzb, FWD_ZT), min(2, Yo)
    co = fwd_channels(cout)
    cs = -(-co // 4) * 4
    nq = (zt + 2) | 1
    rows = (ty - 1) * sy + k
    filt = cin * k**3 * cs * 4
    tx = max(1, min(Xo, FWD_THREADS // (zt * ty)))
    while True:  # halved until one buffer fits (a wide x of Z <= 8 at k 7)
        cols = (tx - 1) * sx + k
        tile = cin * rows * cols * 4 * nq * item
        if filt + tile <= SMEM_MAX or tx == 1:
            break
        tx //= 2
    nbuf = 2 if 2 * (filt + 2 * tile + 1024) <= SM_SMEM else 1
    per_axis = (-(-nzb // zt), -(-Xo // tx), -(-Yo // ty))
    return {"zt": zt, "tx": tx, "ty": ty, "threads": -(-zt * tx * ty // 32) * 32, "per_axis": per_axis,
            "n_tiles": B * per_axis[0] * per_axis[1] * per_axis[2], "rows": rows, "cols": cols, "nq": nq, "cs": cs,
            "co": co, "nbuf": nbuf, "smem": filt + nbuf * tile}


def fwd_tiles(shape, k: int, sy: int, sx: int, plan):
    """Each of K3's tiles, in tile order, as (b, (yo0, yo1), (xo0, xo1),
    (z0, z1), (y_lo, x_lo, z_lo)): the outputs it holds (half-open ranges)
    and the input coordinates of its staged tile's first row, column and
    value (negative in the padding). The tile spans ``plan["rows"]`` rows,
    ``plan["cols"]`` columns and ``4 * plan["nq"]`` z values from there."""
    B, _, Y, X, Z = shape
    Yo, Xo = -(-Y // sy), -(-X // sx)
    zt, tx, ty = plan["zt"], plan["tx"], plan["ty"]
    n_zt, n_xt, n_yt = plan["per_axis"]
    p = k // 2
    tiles = []
    for tile in range(plan["n_tiles"]):  # the kernel's decode of a tile number
        zb0, r = tile % n_zt * zt, tile // n_zt
        xo0, r = r % n_xt * tx, r // n_xt
        yo0, b = r % n_yt * ty, r // n_yt
        tiles.append((b, (yo0, min(yo0 + ty, Yo)), (xo0, min(xo0 + tx, Xo)), (4 * zb0, min(4 * (zb0 + zt), Z)),
                      (yo0 * sy - p, xo0 * sx - p, 4 * zb0 - 4)))
    return tiles


def fwd_thread(t: int, plan):
    """Thread ``t`` of a K3 block: its (z block, xo column, yo row) in a
    tile; it writes z values 4 * z block .. + 3 of that column for every
    channel. Threads past the tile (``threads`` is rounded up to warps)
    have a row past ``ty`` and write nothing."""
    zt, tx = plan["zt"], plan["tx"]
    return t % zt, t // zt % tx, t // zt // tx


def fwd_block_tiles(block: int, grid: int, n_tiles: int):
    """The tiles block ``block`` of K3's persistent grid (of ``grid`` =
    min(tiles, blocks resident on the card) blocks) takes, in its order:
    ``block``, ``block + grid``, ... (the kernel's tile loop)."""
    return list(range(block, n_tiles, grid))


@functools.lru_cache(maxsize=64)
def _fwd_plan(device: int, dtype: int, shape, cout: int, k: int, sy: int, sx: int):
    """``fwd_plan`` for a card and shape with the grid: the smaller of the
    tiles and the blocks resident on the card at once (one occupancy query,
    which also allows K3's instance its shared memory; a launch queries and
    sets nothing)."""
    plan = fwd_plan(shape, k, sy, sx, cout, 2 if dtype else 4)
    if plan["smem"] > SMEM_MAX:
        raise ValueError(f"K3's tile takes {plan['smem']} bytes of shared memory for x {shape}, k {k}; a block has "
                         f"{SMEM_MAX}")
    lib = _load()
    with torch.cuda.device(device):
        capacity = lib.mdt_stem_fwd_capacity(dtype, k, cout, plan["threads"], plan["smem"])
    if capacity < 0:
        _raise(lib, -capacity, "stem conv forward (K3) occupancy query")
    return dict(plan, grid=min(plan["n_tiles"], capacity))


def fwd_launch_plan(x, cout: int, k: int, sy: int, sx: int):
    """K3's launch plan for x (B, cin, Y, X, Z) on its card: ``fwd_plan``
    for x's dtype with ``grid``, kept per card and shape."""
    return _fwd_plan(x.device.index, _DTYPES[x.dtype], tuple(x.shape), cout, k, sy, sx)


def fwd_prepare(x, w, b, sy: int, sx: int):
    """Check K3's operands and build one launch: returns (out, launch args),
    out ``(B, cout, ceil(Y/sy), ceil(X/sx), Z)`` from ``torch.empty``."""
    cout, cin, k = w.shape[0], w.shape[1], w.shape[-1]
    _check(x, k, cout, sy, sx, w=(w, (cout, x.shape[1], k, k, k)), b=(b, (cout,)))
    plan = fwd_launch_plan(x, cout, k, sy, sx)
    B, _, Y, X, Z = x.shape
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty((B, cout, -(-Y // sy), -(-X // sx), Z), dtype=x.dtype, device=x.device)
    # the tensors stay referenced here until the launch is enqueued
    return out, ((x, w, b, out), [x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr()],
                 [_DTYPES[x.dtype], B, cin, Y, X, Z, cout, k, sy, sx]
                 + [plan[n] for n in ("zt", "tx", "ty", "nbuf", "grid")],
                 x.device)


def fwd_launch(launch_args):
    """Enqueue K3 on the current stream; raise if it is refused."""
    _, ptrs, sizes, dev = launch_args
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.mdt_stem_fwd_launch(*ptrs, *sizes, torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, err, "stem conv forward (K3)")


def stem_conv3d(x, w, b, sy: int, sx: int):
    """K3: SAME 3D conv, stride (sy, sx, 1), float32 accumulation, cast, then
    the bias added in x's dtype. x (B, cin, Y, X, Z), w (cout, cin, k, k, k),
    b (cout,), one dtype. Returns (B, cout, ceil(Y/sy), ceil(X/sx), Z) in x's
    dtype, un-synchronised."""
    out, launch_args = fwd_prepare(x, w, b, sy, sx)
    fwd_launch(launch_args)
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
