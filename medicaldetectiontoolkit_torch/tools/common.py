"""Helpers shared by the measurement scripts: the card's identity, float32
precision switches, device timers, the least time of a piece of work on the
card, the served slices and the training slice, one pipelined window of
chunks, timed training steps, and what is alive at a step's memory peak."""

from __future__ import annotations

import subprocess
import time

import torch

from medicaldetectiontoolkit_torch.models import build_model
from medicaldetectiontoolkit_torch.testing import (make_batch, make_mrcnn_slice_config, make_slice_config,
                                                   make_det_unet_slice_config, make_train_slice_config)

# the H100's device-memory rate and peak arithmetic rates by operand type
# (NVIDIA's data sheet, SXM, dense): a bound is the larger of bytes over the
# memory rate and operations over the peak rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# the served slices: 3D Retina U-Net and 3D Mask R-CNN at LIDC width, batch
# 8; the training slice: 3D Retina U-Net at LIDC width, batch 2 x 4; and
# 3D Detection U-Net at LIDC width, batch 8
SLICE_CONFIGS = {"retina_unet": make_slice_config, "mrcnn": make_mrcnn_slice_config,
                 "retina_unet_train": make_train_slice_config, "detection_unet": make_det_unet_slice_config}


class QuietLog:
    def info(self, *args, **kwargs):
        pass


def card_line() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def setup_card() -> str:
    """Require CUDA, switch TF32 off for convs and matmuls (float32 results
    stay float32), and return the card line."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card_line()


def bound(bytes_moved, ops, dtype="float32"):
    """(bound ms, what bounds it) for moving ``bytes_moved`` and doing ``ops``
    operations of ``dtype`` on the card."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls
    (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=20, warmup=3):
    """Mean host time of ``fn`` in ms over ``iters`` calls issued back to
    back, the device left running; then a synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def profiled_kernel_ms(fn, kernel, iters=20):
    """Device time per launch of the kernels whose name holds ``kernel``,
    from ``torch.profiler`` over ``iters`` calls of ``fn``; None if the trace
    holds no such launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return sum(us) / len(us) / 1e3 if us else None


def slice_net(compute_dtype: str, seed: int = 0, model: str = "retina_unet"):
    """A served slice's detector on the card, random weights from ``seed``."""
    net = build_model(SLICE_CONFIGS[model](compute_dtype), QuietLog(), device="cuda")
    net.initialize(seed=seed)
    return net


def slice_batches(n_chunks: int = 3, model: str = "retina_unet"):
    return [make_batch(SLICE_CONFIGS[model](), seed=i) for i in range(n_chunks)]


def run_window(net, batches):
    """Dispatch every chunk, then convert each, as the Predictor's in-flight
    window does. Returns (device handles, results, host seconds of the
    dispatches, host seconds of the whole window ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [net.test_forward_dispatch(b) for b in batches]
    t_dispatch = time.perf_counter() - t0
    results = [net.test_forward_convert(h, b) for h, b in zip(handles, batches)]
    torch.cuda.synchronize()
    return handles, results, t_dispatch, time.perf_counter() - t0


def train_steps(net, batches):
    """One training step per batch (dispatch, then convert without the
    full-volume seg copy, as per-step monitoring does), ending in a
    synchronise. Returns (results, host seconds of each step)."""
    results, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(net.train_forward_convert(net.train_forward_dispatch(b), b, need_seg_preds=False))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return results, times


def _origin(frames, package="medicaldetectiontoolkit_torch"):
    """Where an allocation was made: the innermost frame of ``package`` and
    the next one of another file (its caller), as ``file:line function``."""
    ours = [f for f in frames if package in f.get("filename", "")]
    if not ours:
        return "no frame of the port (autograd's C++ backward, or outside the port)"
    names = [f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']} {f['name']}" for f in ours]
    caller = next((n for f, n in zip(ours[1:], names[1:]) if f["filename"] != ours[0]["filename"]), None)
    return names[0] if caller is None else f"{names[0]} < {caller}"


def peak_allocations(fn, top=5):
    """Run ``fn()`` with the caching allocator's history on (Python frames)
    and replay its allocations and completed frees to the moment of most
    device memory allocated. Returns ``{"peak": bytes, "before": bytes
    allocated when ``fn`` started, "top": [(origin, bytes, count)]}``: the
    ``top`` origins (``_origin``) of the blocks alive at the peak, by bytes,
    the blocks allocated before ``fn`` and still alive there as one origin."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(stacks="python", max_entries=10_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)

    def replay(stop):
        live, old_freed, cur, peak, peak_at = {}, 0, 0, 0, -1
        for i, ev in enumerate(trace[:stop]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
            elif ev["action"] == "free_completed":
                if live.pop(ev["addr"], None) is None:
                    old_freed += ev["size"]  # a block allocated before fn
                cur -= ev["size"]
            if cur > peak:
                peak, peak_at = cur, i
        return live, old_freed, peak, peak_at

    _, _, peak, peak_at = replay(len(trace))
    live, old_freed, _, _ = replay(peak_at + 1)
    by_origin = {"allocated before the step and alive (parameters, Adam state, ...)": [before - old_freed, 0]}
    for ev in live.values():
        entry = by_origin.setdefault(_origin(ev.get("frames", [])), [0, 0])
        entry[0] += ev["size"]
        entry[1] += 1
    ranked = sorted(by_origin.items(), key=lambda kv: -kv[1][0])[:top]
    return {"peak": before + peak, "before": before, "top": [(k, v[0], v[1]) for k, v in ranked]}
