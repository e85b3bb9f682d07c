"""What the per-layer metrics read from the program's own spans and
counters (``medicaldetectiontoolkit_torch/utils/trace.py``, on while the
traced window's profiler records): the summary of the recording made in
this run's window, per request dispatched in it. Each reader returns None
where there is none: a program without that module, the control (which
runs no program code), a recording left by an earlier run in the same
process."""

from __future__ import annotations

import time


def window_summary(run, kind: str):
    """(the program's trace summary, requests dispatched in the window), or
    None."""
    if run.kind != kind or run.program != "port" or not run.traced or run.t0 is None:
        return None
    try:
        from medicaldetectiontoolkit_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()
    window_start_ns = time.time_ns() - (time.perf_counter() - run.t0) * 1e9
    if s.get("opened_ns") is None or s["opened_ns"] < window_start_ns:
        return None
    n = s["spans"].get("dispatch", {}).get("count")
    return (s, n) if n else None


def host_ms(run, kind: str, span: str):
    """Host ms per request in the spans called ``span`` (0 where the
    window's recording holds none)."""
    got = window_summary(run, kind)
    if got is None:
        return None
    s, n = got
    return s["spans"].get(span, {}).get("host_ms", 0.0) / n


def device_ms(run, kind: str, span: str):
    """Device ms per request in the event pairs of the spans called
    ``span`` (None without a pair: no CUDA card)."""
    got = window_summary(run, kind)
    if got is None:
        return None
    s, n = got
    ms = s["spans"].get(span, {}).get("device_ms")
    return None if ms is None else ms / n


def counter(run, kind: str, name: str):
    """A counter's total per request."""
    got = window_summary(run, kind)
    if got is None:
        return None
    s, n = got
    return s["counters"].get(name, 0) / n
