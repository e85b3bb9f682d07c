"""Build, binding, plan and launch of the hand-written CUDA kernel K6
(``csrc/pointwise_wgrad.cu``): the float32 weight gradient of a stride-1
1x1x1 3D conv.

K6 replaces no TPU kernel (``ops/pointwise_wgrad.py``). The source is
compiled at first use by ``ops/cuda_build.py`` (nvcc for ``sm_90a``, a plain
C entry point) and loaded through ``ctypes``.

``pointwise_wgrad`` takes CUDA tensors only, channel-first: x ``(B, cin,
*spatial)`` and dy ``(B, cout, *spatial)``, both float32, viewed as ``(B,
cin, V)`` and ``(B, cout, V)``. It checks them, takes the launch plan
(``plan``, kept per card and shape), allocates dw and the partial scratch
with ``torch.empty`` and enqueues the passes on the current stream without
synchronising. A refused launch raises; there is no fallback.

The plan: dw is cut into tiles of ``tm`` x ``tc`` warps, each warp owning
``R`` x ``R`` entries (every lane the same entries, for its own voxels);
one tile holds all of dw where at most ``MAX_WARPS`` warps and two stages
of rows fit, else the tiles that read the fewest rows in all. The B x V
voxels, in stages of ``VT``, are cut into ``slices`` runs, one partial of dw
each: about as many blocks as the card holds at once, and no run longer
than ``MAX_RUN`` stages. With one slice the partial pass writes dw itself.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from medicaldetectiontoolkit_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "pointwise_wgrad.cu"
R = 6  # kR in the source: a warp's entries of dw are R output x R input channels
VT = 128  # kVt: voxels a stage holds (32 lanes x 4)
STAGES = 4  # kStages: the ring of stages in shared memory
MAX_WARPS = 24  # kMaxWarps: warps a block has at most, and a share of an SM
SMEM_MAX = 232448  # dynamic shared memory a block may take on sm_90
SMEM_SM = 233472  # shared memory of one SM
MAX_RUN = 1024  # stages in a slice at most: each sum adds at most 4 x MAX_RUN products
SCRATCH_BYTES = 2 * 2**20  # the partials of one launch, at most (unless MAX_RUN asks for more slices)
PLAN_KEYS = ("tm", "tc", "slices", "vec")

_lib = None


def build():
    """Compile ``csrc/pointwise_wgrad.cu`` unless a library for this source
    exists; returns its path."""
    return cuda_build.build(SOURCE, "mdt_pointwise_wgrad")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        lib.mdt_pointwise_wgrad_launch.argtypes = [vp] * 4 + [ip, ip, vp]
        lib.mdt_pointwise_wgrad_launch.restype = ctypes.c_int
        lib.mdt_pointwise_wgrad_error_string.argtypes = [ctypes.c_int]
        lib.mdt_pointwise_wgrad_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(tm: int, tc: int) -> int:
    """The partial pass's dynamic shared memory: ``STAGES`` stages of the
    tile's ``R`` x (tm + tc) rows of ``VT`` floats."""
    return STAGES * R * (tm + tc) * VT * 4


@functools.lru_cache(maxsize=1024)
def plan(shape, sms: int, aligned: bool = True):
    """K6's plan for a shape tuple (B, cin, V, cout) on a card of ``sms``
    SMs, or None where it takes none (an empty operand, or more voxels than
    32-bit indices count). A dict of ``PLAN_KEYS``, ``ntm`` / ``ntc`` (tiles
    along cout / cin), ``n_stages``, ``threads``, ``smem`` and ``scratch``
    (partial floats; 0 with one slice).

    The tile: among ``tm`` x ``tc`` warps (at most ``MAX_WARPS``, their
    stages within ``SMEM_MAX``) the one whose tiles read the fewest rows per
    voxel in all, then the fewest tiles; evened out over the tiles. The
    slices: enough blocks to fill the card (``sms`` x the blocks an SM
    holds by warps and shared memory), at least ``n_stages`` / ``MAX_RUN``,
    at most ``SCRATCH_BYTES`` of partials otherwise, at most one a stage.
    ``vec`` (16-byte copies) where the tensors are ``aligned`` and V
    divides by 4."""
    B, C, V, M = shape
    if min(B, C, V, M) < 1 or B * V > 2**31 - 1 - VT:
        return None
    gm, gc = -(-M // R), -(-C // R)
    best = None
    for tm in range(1, min(gm, MAX_WARPS) + 1):
        tc = min(gc, MAX_WARPS // tm)
        while tc and smem_bytes(tm, tc) > SMEM_MAX:
            tc -= 1
        if not tc:
            break
        ntm, ntc = -(-gm // tm), -(-gc // tc)
        key = (ntm * ntc * (tm + tc), ntm * ntc)
        if best is None or key < best[0]:
            best = (key, -(-gm // ntm), -(-gc // ntc), ntm, ntc)
    _, tm, tc, ntm, ntc = best
    n_stages = -(-(B * V) // VT)
    tiles, smem = ntm * ntc, smem_bytes(tm, tc)
    per_sm = max(1, min(MAX_WARPS // (tm * tc), SMEM_SM // smem))
    slices = max(1, min(sms * per_sm // tiles, SCRATCH_BYTES // (4 * M * C)))
    slices = min(n_stages, max(slices, -(-n_stages // MAX_RUN)))
    return {"tm": tm, "tc": tc, "slices": slices, "vec": int(aligned and V % 4 == 0), "ntm": ntm, "ntc": ntc,
            "n_stages": n_stages, "threads": 32 * tm * tc, "smem": smem,
            "scratch": slices * M * C if slices > 1 else 0}


def takes(shape) -> bool:
    """Whether K6 has a plan for the shape (B, cin, V, cout) on any card."""
    return plan(tuple(int(v) for v in shape), 1) is not None


@functools.lru_cache(maxsize=8)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _launch_args(device: int, shape, aligned: bool):
    """The plan for a card and shape, with its ctypes int arrays."""
    p = plan(shape, _sms(device), aligned)
    if p is None:
        raise ValueError(f"K6 takes no plan for the conv {shape}")
    return p, (ctypes.c_int * len(shape))(*shape), (ctypes.c_int * len(PLAN_KEYS))(*(p[k] for k in PLAN_KEYS))


def launch_plan(x, dy):
    """K6's plan for these operands on their card (``plan``)."""
    shape = (x.shape[0], x.shape[1], math.prod(x.shape[2:]), dy.shape[1])
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return _launch_args(x.device.index, tuple(int(v) for v in shape), aligned)


def pointwise_wgrad(x, dy):
    """K6: dw (cout, cin) float32 of the stride-1 1x1x1 conv of x (B, cin,
    *spatial), from its output gradient dy (B, cout, *spatial);
    un-synchronised. Deterministic: every sum is taken in a fixed order."""
    if x.dim() < 2 or dy.dim() != x.dim() or x.device.type != "cuda" or dy.device != x.device or \
            x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise ValueError(f"K6 takes float32 (B, C, ...) CUDA tensors on one card; got x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, dy {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"dy {tuple(dy.shape)} does not match a 1x1x1 conv of x {tuple(x.shape)}")
    x, dy = x.contiguous(), dy.contiguous()
    p, shape_arr, plan_arr = launch_plan(x, dy)
    dw = torch.empty((dy.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    partial = torch.empty(p["scratch"], dtype=torch.float32, device=x.device) if p["scratch"] else dw
    lib = _load()
    with torch.cuda.device(x.device):
        err = lib.mdt_pointwise_wgrad_launch(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                                             shape_arr, plan_arr, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointwise weight gradient (K6) launch failed: "
                           f"{lib.mdt_pointwise_wgrad_error_string(err).decode()} ({err})")
    pointwise_wgrad.launches += 1
    return dw


# kernel launches since the last reset; the main path's proof of use
pointwise_wgrad.launches = 0
