"""The benchmark's own host spans and the reduction of a traced window.

``Spans`` records, around each call the harness makes into the program,
the span's name and its host-clock start and end; with a profiler running
each span is also a ``record_function`` range, so the trace shows what the
host was doing in every idle gap of the device. ``reduce_trace`` turns a
``torch.profiler`` trace into the device's kernels, its busy time (the
union of kernel, copy and memset intervals), the idle gaps labelled by the
span the host was in, and the kernel classes."""

from __future__ import annotations

import contextlib
import time

# kernel-name substrings -> class, first match wins (the measured package's
# ``tools/profile_slice.py`` classes: each hand-written kernel its own class)
CLASSES = (
    ("nms", ("nms_kernel",)),
    ("K3 stem_fwd", ("stem_fwd_kernel",)),
    ("K4 partial pass", ("stem_wgrad_partial_kernel",)),
    ("K4 reduce", ("stem_wgrad_reduce_kernel",)),
    ("K2 backward", ("pyramid_roi_align_bwd_kernel",)),
    ("roi_align", ("pyramid_roi_align_kernel",)),
    ("sort", ("sort", "Sort", "radix", "Radix")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "xmma", "cudnn", "Nhwc", "nhwc", "Nchw",
              "nchw", "cutlass", "gemm")),
    ("upsample", ("upsample",)),
    ("pool", ("pool",)),
    ("copy", ("Memcpy", "Memset", "copy")),
    ("reduce", ("reduce", "Reduce")),
)
SPAN_PREFIX = "bench."
# the trace's activities that occupy the device
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise/other"


class Spans:
    """Host-clock spans of the harness's calls into the program."""

    def __init__(self):
        self.records = []  # (name, start s, end s), time.perf_counter
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str):
        """(count, seconds) of the spans called ``name``."""
        ds = [t1 - t0 for n, t0, t1 in self.records if n == name]
        return len(ds), sum(ds)


def _activity(e) -> str:
    """The trace event's kind as kineto names it: ``kernel``, ``gpu_memcpy``,
    ``gpu_memset`` on the device, ``user_annotation``, ``cuda_runtime``,
    ``cpu_op`` on the host. PyTorch builds whose events do not carry it are
    told apart by device and name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = kind()
        return kind if isinstance(kind, str) else getattr(kind, "name", str(kind)).lower()
    name = e.name()
    if e.device_type().name == "CUDA":
        if name.startswith(SPAN_PREFIX) or e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "cuda_runtime" if name.startswith(("cuda", "Command Buffer")) else "kernel"
    if name.startswith(SPAN_PREFIX):
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def reduce_trace(prof, window_s: float):
    """The device's view of a traced window: kernels as (name, start us,
    duration us), busy seconds, idle gaps labelled by the host's span, the
    device time by kernel class and by operation."""
    kernels, spans, runtime = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3
        kind = _activity(e)
        if kind in DEVICE_WORK:
            kernels.append((name, start, dur))
        elif kind == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, start + dur))
        elif kind == "cuda_runtime":
            runtime[name] = runtime.get(name, 0.0) + dur / 1e6
    busy_us, gaps = _union([(s, s + d) for _, s, d in kernels])
    spans.sort(key=lambda s: s[1])

    def host_at(t):
        label = "outside the harness's spans"
        for name, s, e in spans:
            if s > t:
                break
            if e >= t:
                label = name
        return label

    gaps.sort(key=lambda g: g[0] - g[1])
    by_class, by_op = {}, {}
    for name, _, dur in kernels:
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + dur / 1e6
        by_op[name] = by_op.get(name, 0.0) + dur / 1e6
    idle_by_span = {}
    for s, e in gaps:
        label = host_at(s)
        idle_by_span[label] = idle_by_span.get(label, 0.0) + (e - s) / 1e6
    return {
        "kernels": kernels,
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "by_class": by_class,
        "breakdown": {
            "device_ops": sorted(([n[:200], s] for n, s in by_op.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": [[host_at(s), (e - s) / 1e6] for s, e in gaps[:10]],
        },
        "idle_by_span": idle_by_span,
        "host_runtime": sorted(runtime.items(), key=lambda x: -x[1])[:6],
    }
