"""The traced jobs, after the window, in two parts.

* The window's first jobs again, with their seeds, for ``seconds`` (at
  least one job, at most the window's), under a ``torch.profiler`` that
  records only the card's activity: the card's busy time (the union of
  its kernels, copies and memsets), the traced window by the host's clock
  (from a synchronized start to a synchronized end), and the device
  operations that took most time.  These jobs are the ones the per-layer
  device metrics read.  The profiler still slows the host's launches
  (a launch-bound job by a quarter and more), so ``untraced_s`` is the
  same jobs' time in the untraced window: the same work on the card,
  which the idle shares are taken against.
* One more job under a profiler that also records the host's operations,
  which slows the host down: only for ``idle_gaps``, the card's idle time
  by what the host was doing.  Nothing else is read from it.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "perfbench.traced"
TOP = 10
NAME = 120           # characters kept of an operation's name


def _events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def traced(loop, seconds: float, window: list) -> tuple[list, dict]:
    """(the records of the jobs traced for the device metrics, the
    reduction: ``busy_s``, ``window_s``, ``untraced_s``, ``device_ops``,
    ``idle_gaps``) of ``loop`` after its window's job records ``window``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    records = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        while not records or (time.monotonic() - t0 < seconds
                              and len(records) < len(window)):
            records.append(loop.replay(len(records)))
        torch.cuda.synchronize()
        window_s = time.monotonic() - t0
    out = device_time(_events(prof))
    out["window_s"] = window_s
    out["untraced_s"] = sum(j["job_s"] for j in window[:len(records)])

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            loop.job()
            torch.cuda.synchronize()
    out["idle_gaps"] = idle_gaps(_events(prof))
    return records, out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(totals: dict) -> list:
    return [[name, sec] for name, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def _device_spans(xs: list, w0: float, w1: float):
    """(the merged busy intervals in [w0, w1], seconds by operation)."""
    ops, spans = {}, []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            spans.append((a, b))
            name = e["name"][:NAME]
            ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
    return _merge(spans), ops


def device_time(events: list) -> dict:
    """``busy_s`` and ``device_ops`` of a chrome trace (timestamps in
    microseconds): every device operation in it."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    busy, ops = _device_spans(xs, -float("inf"), float("inf"))
    if not busy:
        raise RuntimeError("the trace holds no operation on the device")
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": _top(ops)}


def idle_gaps(events: list) -> list:
    """The card's idle time inside the ``WINDOW`` span of a chrome trace,
    by the host's innermost span and operation at each gap's middle."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    busy, _ = _device_spans(xs, w0, w1)
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS
                   and e.get("tid") == win.get("tid")
                   and e.get("pid") == win.get("pid")),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))
    idle = {}
    stack, i = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while i < len(host) and float(host[i]["ts"]) <= mid:
            e = host[i]
            i += 1
            while stack and _end(stack[-1]) <= float(e["ts"]):
                stack.pop()
            stack.append(e)
        while stack and _end(stack[-1]) < mid:
            stack.pop()
        idle[_what(stack)] = idle.get(_what(stack), 0.0) + (g1 - g0) * 1e-6
    return _top(idle)


def _end(e) -> float:
    return float(e["ts"]) + float(e["dur"])


def _what(stack) -> str:
    """What the host was doing: its innermost span and op."""
    spans = [e["name"] for e in stack if e.get("cat") == "user_annotation"
             and e["name"] != WINDOW]
    ops = [e["name"] for e in stack if e.get("cat") != "user_annotation"]
    where = spans[-1] if spans else "perfbench"
    return f"{where} > {ops[-1] if ops else 'python'}"[:NAME]
