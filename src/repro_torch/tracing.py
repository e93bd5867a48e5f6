"""Spans and counters inside the port: where a fit's time goes, by layer.

::

    from repro_torch import tracing

    tracing.enable(True)
    result = api.fit(X, cfg)
    ids, f = api.evaluate(result, X)
    snap = tracing.snapshot()      # spans and counters since the last one
    tracing.enable(False)

A span names one call of a layer (``core.kmeanspp.seed``,
``core.kmeans.lloyd``, ...).  While tracing is off it costs one check of a
flag: :func:`span` returns one shared no-op context, and nothing is
recorded.  While a ``torch.profiler`` records, each span also enters a
``torch.profiler.record_function`` of its name, so the profiler's trace
shows the program's layers beside the device's operations, on one clock.
With :func:`enable`, each span is also kept in memory: its name, the span
it ran inside (per thread), its host ``perf_counter`` start and end, and,
on a CUDA device, a pair of timing events recorded on the current stream.
:func:`snapshot` sums them by name.

A counter (:func:`count`) counts while tracing is on.  The program's
``host_sync.<layer>.<what>`` counters count the places where the host
reads a value the device computed: on a CUDA device each such read waits
for the card (a synchronize, or a copy to the host and its wait).  The
kernels' launches are counted apart, always, by
:func:`repro_torch.kernels.ops.launch_counts`.
"""
from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _profiler

_lock = threading.Lock()
_on = False
_records: list = []
_counters: dict[str, int] = {}
_local = threading.local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "parent", "t0", "t1", "events", "annotation")

    def __init__(self, name: str, device):
        self.name = name
        self.parent = None
        self.t0 = self.t1 = 0.0
        dev = None if device is None else torch.device(
            getattr(device, "device", device))
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True), dev)
                       if dev is not None and dev.type == "cuda" else None)
        self.annotation = (torch.profiler.record_function(name)
                           if _profiler._is_profiler_enabled else None)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if self.annotation is not None:
            self.annotation.__enter__()
        if self.events is not None:
            self.events[0].record(torch.cuda.current_stream(self.events[2]))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.events[2]))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _stack().pop()
        with _lock:
            _records.append(self)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, device=None):
    """A context manager for one call of the layer ``name``; ``device`` (a
    ``torch.device`` or a tensor) is where its work runs: on a CUDA device
    a recorded span also times the device's stream."""
    if _on:
        return _Span(name, device)
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NOOP


def count(name: str, by: int = 1) -> None:
    """Add ``by`` to the counter ``name`` (nothing while tracing is off)."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(by)


def enable(on: bool = True) -> None:
    """Record spans and counters from now on (or stop recording)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _device_ms(rec: _Span) -> float | None:
    if rec.events is None:
        return None
    start, end, _ = rec.events
    end.synchronize()
    return start.elapsed_time(end)


def snapshot() -> dict:
    """The spans finished and the counts made since the last snapshot:
    ``{"spans": {name: {"count", "host_ms", "device_ms",
    "self_device_ms", "parents"}}, "counters": {name: n}}``.

    ``device_ms`` is the time between the span's two events on its
    device's stream (waiting for the last one), idle gaps included;
    ``self_device_ms`` leaves out the spans recorded inside it; both are
    None for a span that ran on the CPU.  ``parents`` lists the names of
    the spans it ran inside (per thread), ``None`` for none."""
    with _lock:
        records, counters = list(_records), dict(_counters)
        _records.clear()
        _counters.clear()
    dev = {id(r): _device_ms(r) for r in records}
    inner = dict.fromkeys(dev, 0.0)
    for r in records:
        if r.parent is not None and id(r.parent) in inner \
                and dev[id(r)] is not None:
            inner[id(r.parent)] += dev[id(r)]
    spans: dict[str, dict] = {}
    for r in records:
        s = spans.setdefault(r.name, {
            "count": 0, "host_ms": 0.0, "device_ms": None,
            "self_device_ms": None, "parents": []})
        s["count"] += 1
        s["host_ms"] += 1e3 * (r.t1 - r.t0)
        if dev[id(r)] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + dev[id(r)]
            s["self_device_ms"] = ((s["self_device_ms"] or 0.0)
                                   + dev[id(r)] - inner[id(r)])
        parent = None if r.parent is None else r.parent.name
        if parent not in s["parents"]:
            s["parents"].append(parent)
    return {"spans": spans, "counters": counters}
