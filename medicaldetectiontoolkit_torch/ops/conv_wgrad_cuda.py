"""Build, binding, plan and launch of the hand-written CUDA kernel K5
(``csrc/conv_wgrad.cu``): the float32 weight gradient of a 3D conv.

K5 replaces no TPU kernel (``ops/conv_wgrad.py``). The source is compiled at
first use by ``ops/cuda_build.py`` (nvcc for ``sm_90a``, a plain C entry
point) and loaded through ``ctypes``.

``conv3d_wgrad`` takes CUDA tensors only, channel-first: x ``(B, cin, Y, X,
Z)`` and dy ``(B, cout, Yo, Xo, Zo)``, both float32. It checks them, takes
the launch plan (``plan``, kept per card and shape), allocates dw and the
partial scratch with ``torch.empty`` and enqueues the two passes on the
current stream without synchronising. A refused launch raises; there is no
fallback.

The plan: a block owns a tile of dw (every output channel in ``ms`` slots of
``tm``; ``ct`` groups of 4 input channels; ``kyt`` rows of ky; every kx; kz
in ``kzg`` groups of ``kzt`` taps), one thread per (slot, group, ky, kx, kz
group), at most ``MAX_THREADS``; the reduction over the output voxels is cut
into chunks of ``nb`` x ``ny`` x ``nx`` x ``nz`` voxels (up to
``CHUNK_VOXELS``, as far as two buffers of the chunk's dy and haloed x fit in
shared memory) and the chunks into ``slices`` runs, one partial of dw each:
about one block per SM, at most ``SCRATCH_BYTES`` of partials.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from medicaldetectiontoolkit_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "conv_wgrad.cu"
MAX_THREADS = 384  # kMaxThreads in the source
SMEM_MAX = 232448  # kSmemMax in the source
SCRATCH_BYTES = 16 * 2**20  # the partials of one launch, at most
Z_CHUNK = 64  # output z values per chunk, at most
CHUNK_VOXELS = 256  # output voxels per chunk aimed at
PLAN_KEYS = ("tm", "kzt", "kzg", "ms", "ct", "kyt", "n_ci", "n_ky", "nb", "ny", "nx", "nz", "vec", "slices")

_lib = None


def build():
    """Compile ``csrc/conv_wgrad.cu`` unless a library for this source
    exists; returns its path."""
    return cuda_build.build(SOURCE, "mdt_conv_wgrad")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        lib.mdt_conv_wgrad_launch.argtypes = [vp] * 4 + [ip, ip, vp]
        lib.mdt_conv_wgrad_launch.restype = ctypes.c_int
        lib.mdt_conv_wgrad_error_string.argtypes = [ctypes.c_int]
        lib.mdt_conv_wgrad_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def out_size(shape):
    """(Yo, Xo, Zo) of a shape tuple (B, cin, Y, X, Z, cout, ky, kx, kz, sy,
    sx, py, px, pz); the z stride is 1."""
    _, _, Y, X, Z, _, KY, KX, KZ, sy, sx, py, px, pz = shape
    return (Y + 2 * py - KY) // sy + 1, (X + 2 * px - KX) // sx + 1, Z + 2 * pz - KZ + 1


def _row_pitch(n: int) -> int:
    """``row_pitch`` in the source: the smallest pitch of at least n words
    that is 4 mod 8."""
    p = -(-n // 4) * 4
    return p if p // 4 % 2 else p + 4


def smem_bytes(shape, p) -> int:
    """The partial pass's dynamic shared memory for a plan ``p`` (two
    buffers of the chunk's dy rows and x window rows): ``buf_words`` x 2 x 4
    in the source."""
    _, _, _, _, _, _, _, KX, _, sy, sx, _, _, pz = shape
    q = 4 if p["vec"] else 1
    zoff = (4 - pz % 4) % 4 if p["vec"] else 0
    wy, wx = (p["ny"] - 1) * sy + p["kyt"], (p["nx"] - 1) * sx + KX
    wzp = -(-(zoff + p["nz"] + p["kzg"] * p["kzt"] - 1) // q) * q
    pdy = _row_pitch(p["nb"] * p["ny"] * p["nx"] * p["nz"])
    pxc = _row_pitch(p["nb"] * wy * wx * wzp)
    return 2 * (p["ms"] * p["tm"] * pdy + 4 * p["ct"] * pxc) * 4


@functools.lru_cache(maxsize=1024)
def plan(shape, sms: int, aligned: bool = True):
    """K5's plan for a shape tuple (B, cin, Y, X, Z, cout, ky, kx, kz, sy,
    sx, py, px, pz) on a card of ``sms`` SMs, or None where it takes none
    (more than ``MAX_THREADS`` threads for one row of ky, or one voxel's
    chunk past the shared memory). A dict of ``PLAN_KEYS``, ``n_chunks``,
    ``threads``, ``smem`` and ``scratch`` (partial floats).

    kz is taken in groups of ``kzt`` = 7 where kz divides by 7, else 3;
    ``tm`` = 8 output channels a thread where cout divides by 8 and kzt is 3,
    else 4. ky rows and input-channel groups are dealt evenly into tiles of
    at most ``MAX_THREADS`` threads. ``vec`` (16-byte copies) where the
    tensors are ``aligned`` and Z and Zo divide by 4. The chunk grows from
    one output row of ``min(Zo, Z_CHUNK)`` z values, doubling x, then y
    (then the batch once a chunk holds a whole image), while its voxels stay
    under ``CHUNK_VOXELS`` and two buffers fit. ``slices``: the chunks cut
    into about one block per SM, each slice's partial of dw at most
    ``SCRATCH_BYTES`` in all."""
    B, C, Y, X, Z, M, KY, KX, KZ, sy, sx, py, px, pz = shape
    Yo, Xo, Zo = out_size(shape)
    if min(Yo, Xo, Zo) < 1:
        return None
    kzt = 7 if KZ % 7 == 0 else 3
    kzg = -(-KZ // kzt)
    tm = 8 if M % 8 == 0 and kzt == 3 else 4
    ms = -(-M // tm)
    row = ms * KX * kzg  # threads of one input-channel group and one ky row
    if row > MAX_THREADS:
        return None
    kyt = min(KY, MAX_THREADS // row)
    n_ky = -(-KY // kyt)
    kyt = -(-KY // n_ky)
    gc = -(-C // 4)
    ct = min(gc, MAX_THREADS // (row * kyt))
    n_ci = -(-gc // ct)
    ct = -(-gc // n_ci)
    base = {"tm": tm, "kzt": kzt, "kzg": kzg, "ms": ms, "ct": ct, "kyt": kyt, "n_ci": n_ci, "n_ky": n_ky}
    for vec in ((1, 0) if aligned and Z % 4 == 0 and Zo % 4 == 0 else (0,)):
        p = dict(base, vec=vec, nb=1, ny=1, nx=1, nz=min(Zo, Z_CHUNK))
        if smem_bytes(shape, p) <= SMEM_MAX:
            break
    else:
        return None
    while p["nb"] * p["ny"] * p["nx"] * p["nz"] < CHUNK_VOXELS:
        if p["nx"] < Xo and p["nx"] <= p["ny"]:
            grown = dict(p, nx=min(2 * p["nx"], Xo))
        elif p["ny"] < Yo:
            grown = dict(p, ny=min(2 * p["ny"], Yo))
        elif p["nx"] < Xo:
            grown = dict(p, nx=min(2 * p["nx"], Xo))
        elif p["nb"] < B:
            grown = dict(p, nb=min(2 * p["nb"], B))
        else:
            break
        if smem_bytes(shape, grown) > SMEM_MAX:
            break
        p = grown
    n_chunks = -(-B // p["nb"]) * -(-Yo // p["ny"]) * -(-Xo // p["nx"]) * -(-Zo // p["nz"])
    mn = M * C * KY * KX * KZ
    slices = max(1, min(n_chunks, sms // (n_ci * n_ky), SCRATCH_BYTES // (4 * mn)))
    threads = ms * ct * kyt * KX * kzg
    return dict(p, slices=slices, n_chunks=n_chunks, threads=-(-threads // 32) * 32,
                smem=smem_bytes(shape, p), scratch=slices * mn)


def takes(shape) -> bool:
    """Whether K5 has a plan for the shape (on any card)."""
    return plan(tuple(int(v) for v in shape), 1) is not None


@functools.lru_cache(maxsize=8)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _launch_args(device: int, shape, aligned: bool):
    """The plan for a card and shape, with its ctypes int arrays."""
    p = plan(shape, _sms(device), aligned)
    if p is None:
        raise ValueError(f"K5 takes no plan for the conv {shape}")
    return p, (ctypes.c_int * len(shape))(*shape), (ctypes.c_int * len(PLAN_KEYS))(*(p[k] for k in PLAN_KEYS))


def launch_plan(x, dy, kernel_size, stride, padding):
    """K5's plan for these operands on their card (``plan``)."""
    shape = (*x.shape, dy.shape[1], *kernel_size, stride[0], stride[1], *padding)
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return _launch_args(x.device.index, tuple(int(v) for v in shape), aligned)


def conv3d_wgrad(x, dy, kernel_size, stride, padding):
    """K5: dw (cout, cin, *kernel_size) float32 of the conv of x (B, cin, Y,
    X, Z) with stride (sy, sx, 1) and ``padding``, from the output gradient
    dy (B, cout, Yo, Xo, Zo); un-synchronised. Deterministic: the slices'
    partials are summed in a fixed order."""
    if x.dim() != 5 or dy.dim() != 5 or x.device.type != "cuda" or dy.device != x.device or \
            x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise ValueError(f"K5 takes float32 (B, C, Y, X, Z) CUDA tensors on one card; got x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, dy {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if len(kernel_size) != 3 or stride[2] != 1 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"K5 takes 3D kernels with z stride 1; got kernel {kernel_size}, stride {stride}")
    x, dy = x.contiguous(), dy.contiguous()
    p, shape_arr, plan_arr = launch_plan(x, dy, kernel_size, stride, padding)
    if tuple(dy.shape[2:]) != out_size(tuple(shape_arr)):
        raise ValueError(f"dy {tuple(dy.shape)} does not match the conv of x {tuple(x.shape)}")
    M, C = dy.shape[1], x.shape[1]
    partial = torch.empty(p["scratch"], dtype=torch.float32, device=x.device)
    dw = torch.empty((M, C, *kernel_size), dtype=torch.float32, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        err = lib.mdt_conv_wgrad_launch(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(), shape_arr,
                                        plan_arr, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv weight gradient (K5) launch failed: {lib.mdt_conv_wgrad_error_string(err).decode()} "
                           f"({err})")
    conv3d_wgrad.launches += 1
    return dw


# kernel launches since the last reset; the main path's proof of use
conv3d_wgrad.launches = 0
