"""What the per-layer metrics read from a run (``run.py``'s ``Context``):
the harness's spans, the reduced trace of the window and the work counts.
Each reader returns None where the run has nothing for it to read."""

from __future__ import annotations

from benchmark.core import work


def dispatch_ms(run, kind: str):
    """Host ms per request in the harness's span around the dispatch call."""
    n, s = run.spans.total("dispatch")
    return s / n * 1e3 if run.kind == kind and n else None


def class_ms(run, kind: str, cls: str):
    """Device ms per request of one kernel class."""
    if run.kind != kind or run.trace is None or not run.trace["by_class"].get(cls):
        return None
    return run.trace["by_class"][cls] / run.requests * 1e3


def mfu(run, kind: str):
    """% of the card's float32 peak: the model's FLOPs of every request
    completed in the window over the window's seconds."""
    if run.kind != kind:
        return None
    return run.flops_per_request * run.requests / run.window_s / work.PEAK_FLOPS["float32"] * 100


def idle_pct(run, kind: str):
    """% of the traced window with no kernel, copy or memset on the card."""
    if run.kind != kind or run.trace is None or not run.trace["busy_s"]:
        return None
    return (1.0 - run.trace["busy_s"] / run.window_s) * 100


def kernel_time_s(run, name: str):
    """(launches, device seconds) of the kernels whose name holds ``name``."""
    ds = [d for n, _, d in run.trace["kernels"] if name in n]
    return len(ds), sum(ds) / 1e6


def roofline(run, kind: str, names, bound_s: float, per: str):
    """% of a kernel's least time (``core/work.py``) over its measured time
    in the window, summed over its launches; ``bound_s`` is per launch of
    ``names[0]`` (``per`` "launch") or per request (``per`` "request")."""
    if run.kind != kind or run.trace is None:
        return None
    n, _ = kernel_time_s(run, names[0])
    t = sum(kernel_time_s(run, k)[1] for k in names)
    if not n or not t:
        return None
    return bound_s * (n if per == "launch" else run.requests) / t * 100
