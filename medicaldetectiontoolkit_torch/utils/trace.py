"""Spans and counters of the port's detector host API, on the device
trace's clock.

**Spans.** ``with span(name, device=None, **attrs):`` marks one stage. The
detectors (``models/base.py``, ``retina_net.py``, ``mrcnn.py``,
``detection_unet.py``) open the same names:

* ``dispatch`` (attr ``kind``: train, val or test) around
  ``train_forward_dispatch`` / ``test_forward_dispatch``, and inside it
  ``upload`` (the batch's copies to the card), ``forward`` (the FPN and
  heads: ``Detector._spatial`` / ``_spatial_train``), Mask R-CNN's
  ``proposals`` (K1), ``classify_all`` (K2 over every proposal) and
  ``targets`` (detection targets, inside ``losses``), ``losses`` (matching,
  SHEM and the loss sums of one microbatch), ``backward``, ``update`` (the
  data-parallel gradient reduce and Adam), ``refine`` (detection
  refinement: top-k, decode, K1, merge) and ``host_copies``
  (``start_host_copies``);
* ``convert`` around ``*_forward_convert``, and inside it ``assemble`` (the
  box dicts and seg preds);
* ``wait`` (attr ``what``) wherever the host blocks on the device: an
  event's ``synchronize()``, a pageable ``.cpu()`` copy.

The Predictor opens ``predictor.patient``, ``predictor.forward`` and
``predictor.consolidation``. A span's parent is the span open on its thread
when it starts; a dispatch draws a request id (``request()``) that its spans
and its handles carry (``models/base.py::Handles``), and the convert of
those handles opens its spans under the same id.

**Counters.** ``count(name, n)`` adds to a total, from values the host
already holds (shapes, byte counts, host copies already made), never from a
read of the device: ``upload.bytes`` and ``upload.calls``
(``base.host_to_device``), ``k1.lanes`` and ``k1.candidates`` (lanes and
lane entries of each NMS launch), ``k2.slots`` (RoIs of each classify-all
launch, padding included), ``k5.calls`` and ``k6.calls`` (calls of the conv
weight-gradient kernels, ``ops/conv_wgrad.py``, ``ops/pointwise_wgrad.py``),
``detections`` (served rows) and ``proposals`` (a training step's valid
proposals).

**The switch.** Tracing is on while a ``torch.profiler`` records, or
between ``enable()`` and ``disable()``. A recording starts empty at the
first span or counter after tracing turns on and ends at ``disable()`` or
at the first span or counter after tracing turns off (two profilers with no
span between them make one recording); it is kept in memory
(``MAX_RECORDS`` raw spans; the totals stay whole past that) until the next
one starts. Off, ``span`` returns one shared no-op context after one check
(no clock read, no ``record_function``; 0.7 us a ``with`` block and 0.2 us
a ``count`` on one Xeon core) and ``count`` returns at once; on, a span
costs about 17 us there without a profiler, its ``record_function``
included.

**The clock.** A span's start and end are ``time.time_ns()``, Unix-epoch
ns, the clock kineto stamps its host and device events with; each span is
also a ``torch.profiler.record_function`` range named ``mdt.<name>``, so
the spans sit in every profiler trace on the device's timeline. A span
given a CUDA ``device`` also records a timing CUDA-event pair on that
device's current stream, resolved only when ``summary()`` or ``records()``
is read: nothing synchronises on the hot path.

**Reading.** ``summary()``: per span name the count, host ms, self ms (the
duration less the time its child spans cover) and device ms (the stream's
time between the pair's events, so idle time of the card inside the stage
counts too; None without an event pair), and each counter's total.
``records()``: the raw spans.

The collective counters of ``parallel/mesh.py::SpaceGroup.stats`` (and its
synchronising ``timing``) are apart from this module: they count the
collectives that ``testing.py`` and ``chip_smoke.py`` check.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

PREFIX = "mdt."
# raw spans one recording keeps; the totals of summary() count every span
MAX_RECORDS = 1 << 16

_profiler_enabled = torch.autograd._profiler_enabled
_forced = False  # enable() called
_open = False  # a recording is collecting
_rec = None  # the current or last recording
_local = threading.local()
_request_ids = itertools.count(1)


class _Recording:
    """One recording: the raw spans, the per-name totals, the event pairs
    not yet resolved and the counters."""

    def __init__(self):
        self.opened_ns = time.time_ns()
        self.lock = threading.Lock()
        self.records = []  # [id, name, parent id, request id, attrs, start ns, end ns, thread, device ms]
        self.ids = itertools.count()
        self.dropped = 0
        self.totals = {}  # name -> [count, host ns, self ns, device ms | None]
        self.pairs = []  # (name, record | None, start event, end event)
        self.counters = {}

    def resolve(self):
        """Device ms of every event pair recorded so far (waits for each
        pair's end event)."""
        with self.lock:
            pairs, self.pairs = self.pairs, []
        for name, record, start, end in pairs:
            end.synchronize()
            ms = start.elapsed_time(end)
            tot = self.totals[name]
            tot[3] = (tot[3] or 0.0) + ms
            if record is not None:
                record[8] = ms


def _recording():
    """The open recording, opening a new one if tracing has just turned on."""
    global _rec, _open
    if not _open:
        _rec, _open = _Recording(), True
    return _rec


def enable():
    """Record from now on, profiler or not, into a new recording."""
    global _forced, _open
    _forced, _open = True, False
    _recording()


def disable():
    """Stop recording; the recording stays readable."""
    global _forced, _open
    _forced = _open = False


def request() -> int:
    """A new request id (a dispatch draws one)."""
    return next(_request_ids)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Timer:
    """A span with tracing off that still adds its host seconds to ``into``."""

    __slots__ = ("into", "key", "t0")

    def __init__(self, into, key):
        self.into, self.key = into, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.into[self.key] += time.perf_counter() - self.t0
        return False


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "into", "key", "rid", "attrs", "rec", "id", "parent", "children_ns", "range",
                 "events", "t0")

    def __init__(self, name, device, into, key, rid, attrs):
        self.name, self.device, self.into, self.key, self.rid, self.attrs = name, device, into, key, rid, attrs

    def __enter__(self):
        rec = self.rec = _recording()
        stack = _stack()
        parent = self.parent = stack[-1] if stack else None
        if self.rid is None and parent is not None:
            self.rid = parent.rid
        self.children_ns = 0
        self.id = next(rec.ids)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.events = None
        dev = self.device
        if dev is not None and dev.type == "cuda" and len(rec.records) < MAX_RECORDS:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(dev))
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        _stack().pop()
        self.range.__exit__(*exc)
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.children_ns += dur
        if self.into is not None:
            self.into[self.key] += dur / 1e9
        rec = self.rec
        with rec.lock:
            tot = rec.totals.get(self.name)
            if tot is None:
                tot = rec.totals[self.name] = [0, 0, 0, None]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.children_ns
            record = None
            if len(rec.records) < MAX_RECORDS:
                record = [self.id, self.name, None if parent is None else parent.id, self.rid, self.attrs, self.t0,
                          t1, threading.get_ident(), None]
                rec.records.append(record)
            else:
                rec.dropped += 1
            if self.events is not None:
                rec.pairs.append((self.name, record, *self.events))
        return False


def span(name: str, device=None, into=None, rid=None, **attrs):
    """A context manager that records one span while tracing is on (the
    module's docstring). ``device``: the torch device the span's work runs
    on; a CUDA device adds a timing event pair on its current stream.
    ``into``: a dict whose entry under the last dotted part of ``name`` gets
    the span's host seconds added, tracing on or off. ``rid``: the request
    id, by default the parent's. ``attrs``: kept with the raw span."""
    if not (_forced or _profiler_enabled()):
        if _open:
            disable()
        if into is None:
            return _NOOP
        return _Timer(into, name.rsplit(".", 1)[-1])
    return _Span(name, device, into, name.rsplit(".", 1)[-1], rid, attrs)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not (_forced or _profiler_enabled()):
        if _open:
            disable()
        return
    rec = _recording()
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def summary() -> dict:
    """The last recording's totals: ``spans`` (per name ``count``,
    ``host_ms``, ``self_ms``, ``device_ms``), ``counters``, ``opened_ns``
    (when it started, Unix-epoch ns; None without a recording) and
    ``dropped`` (spans past ``MAX_RECORDS``, in the totals but not in
    ``records()``)."""
    rec = _rec
    if rec is None:
        return {"spans": {}, "counters": {}, "opened_ns": None, "dropped": 0}
    rec.resolve()
    with rec.lock:
        spans = {name: {"count": c, "host_ms": h / 1e6, "self_ms": s / 1e6, "device_ms": d}
                 for name, (c, h, s, d) in rec.totals.items()}
        return {"spans": spans, "counters": dict(rec.counters), "opened_ns": rec.opened_ns, "dropped": rec.dropped}


def records() -> list:
    """The last recording's raw spans in the order they ended: dicts of
    ``id``, ``name``, ``parent`` (the parent's id or None), ``rid``,
    ``attrs``, ``start_ns``, ``end_ns``, ``thread`` and ``device_ms``."""
    rec = _rec
    if rec is None:
        return []
    rec.resolve()
    keys = ("id", "name", "parent", "rid", "attrs", "start_ns", "end_ns", "thread", "device_ms")
    with rec.lock:
        return [dict(zip(keys, r)) for r in rec.records]
