"""Launch autotuner for the CUDA kernels of the Lloyd hot path.

A port of ``repro/kernels/autotune.py``.  It times a small candidate set of
launch choices ONCE per shape key and caches the winner:

* **in-process** — a dict keyed by ``kind|backend|b|m|k|n|precision``;
* **on disk (optional)** — a JSON cache (``REPRO_AUTOTUNE_CACHE=/path.json``
  or :func:`set_cache_path`), ``{"version": 1, "entries": {...}}``, written
  merge-on-write with an atomic ``os.replace``, so the timing survives
  restarts and a deployment can pin a profile per card type.

``repro_torch.kernels.ops`` consults :func:`get_blocks` for every launch on
the card (never for CPU tensors).  Resolution: in-process cache -> disk
cache -> (when tuning is enabled and a bench is given) time the candidates
and cache the winner -> the defaults.  Tuning is off by default; enable it
with ``REPRO_AUTOTUNE=1``, :func:`enable`, or ``BigMeansConfig(autotune=
True)``, which tunes the fit's shapes before it runs.  A cached winner is
used even when tuning is off: that is how a profile is pinned.

What a candidate is differs from the reference, whose TPU tilings
(``block_m``, ``block_k``, ``block_n``) mean nothing here.  Every candidate
leaves every output bitwise equal, so a tuned fit is bitwise the untuned
fit:

* ``"fused"`` — ``{"pipeline": "blocks"}`` (kernel A) first, then
  ``{"pipeline": "dma"}`` (A-dma): one CTA body on one grid, the point
  slabs read when needed or copied ahead;
* ``"fused_batched"`` — the default alone (kernel D has no other launch
  whose partition of the float sums is the same);
* ``"assign"`` — ``{"ctas_per_sm": 2}`` first, then 1 and 4: rows are
  assigned independently, so the grid changes no id and no distance.

The grid, the tile sizes and the reduction order never vary.  Keys name
the backend ``cuda-sm_<major><minor>`` of the card, so a port entry is
never read as a TPU or interpret entry of the reference; both packages may
share one cache file, and merge-on-write keeps both's entries.

Departure from the reference: a candidate whose build or run raises is not
skipped (``autotune.py:279-283`` there) — :func:`get_blocks` raises, naming
the candidate, so a kernel that fails is never quietly not chosen.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

_DEFAULTS: dict[str, dict] = {
    "assign": {"ctas_per_sm": 2},
    "fused": {"pipeline": "blocks"},
    "fused_batched": {},
}

_lock = threading.RLock()
_cache: dict[str, dict] = {}          # key -> winning launch choice
_loaded_paths: set[str] = set()
_enabled: bool = os.environ.get("REPRO_AUTOTUNE", "") not in ("", "0")
_cache_path: str | None = os.environ.get("REPRO_AUTOTUNE_CACHE") or None

_WARMUP, _REPS = 2, 5
_LAUNCHES = 10      # a timed rep on the card: launches between two events

# Cache files that failed to load (corrupt JSON, stale or unknown schema)
# are ignored, never fatal — and each ignore is recorded here, so that
# ``repro_torch.api.fit`` surfaces it in the run's trace.
_events: list[tuple] = []
# Every candidate timed in this process: (key, candidate, seconds).
_timings: list[tuple] = []


def events() -> list[tuple]:
    """Every cache-load anomaly this process has recorded, in order:
    ``("autotune_cache_ignored", path, reason)`` for a whole file and
    ``("autotune_cache_entry_ignored", path, key)`` for one entry."""
    return list(_events)


def timings() -> list[tuple]:
    """Every candidate timed in this process, in order: ``(key,
    candidate, best seconds of _REPS runs)``.  They never leave the
    process except as cached winners."""
    return list(_timings)


def _record_event(kind: str, *info) -> None:
    _events.append((kind,) + info)


def enable(on: bool = True) -> None:
    """Turn timing-based tuning on/off process-wide (lookups always work)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def set_cache_path(path: str | os.PathLike | None) -> None:
    """Point the on-disk JSON cache at ``path`` (``None`` disables disk)."""
    global _cache_path
    _cache_path = None if path is None else os.fspath(path)


def cache_path() -> str | None:
    return _cache_path


def clear(disk: bool = False) -> None:
    """Drop every cached winner (and the disk cache file when ``disk``)."""
    with _lock:
        _cache.clear()
        _loaded_paths.clear()
        if disk and _cache_path and os.path.exists(_cache_path):
            os.remove(_cache_path)


def cache_key(kind: str, *, backend: str, b: int, m: int, k: int, n: int,
              precision: str) -> str:
    return f"{kind}|{backend}|b{b}|m{m}|k{k}|n{n}|{precision}"


def _valid_entry(blocks) -> bool:
    """A disk-cache entry ops can read launch choices from."""
    if not isinstance(blocks, dict):
        return False
    return all(
        isinstance(name, str)
        and (val is None or isinstance(val, (int, str))
             and not isinstance(val, bool))
        for name, val in blocks.items())


def load_disk() -> None:
    """Load the disk cache into the in-process one, once per path (a
    lookup does it on first use; ``fit`` does it up front, so a bad file is
    reported in its trace whatever the device)."""
    with _lock:
        if not _cache_path or _cache_path in _loaded_paths:
            return
        _loaded_paths.add(_cache_path)
        try:
            with open(_cache_path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return                      # no cache yet: the normal first run
        except (OSError, ValueError) as exc:
            _record_event("autotune_cache_ignored", _cache_path,
                          f"unreadable: {type(exc).__name__}: {exc}")
            return
        if not isinstance(data, dict) \
                or not isinstance(data.get("entries"), dict):
            _record_event("autotune_cache_ignored", _cache_path,
                          "not a cache object")
            return
        if data.get("version") != 1:
            _record_event("autotune_cache_ignored", _cache_path,
                          f"stale schema version {data.get('version')!r}")
            return
        for key, blocks in data["entries"].items():
            if not _valid_entry(blocks):
                _record_event("autotune_cache_entry_ignored", _cache_path,
                              key)
                continue
            _cache.setdefault(key, blocks)


def _save_disk() -> None:
    if not _cache_path:
        return
    # Merge-on-write: re-read the file so that processes (and packages)
    # sharing one cache path keep each other's entries (this process's
    # winners take precedence); os.replace keeps each write atomic.
    merged: dict[str, dict] = {}
    try:
        with open(_cache_path) as f:
            merged.update(json.load(f).get("entries", {}))
    except (OSError, ValueError, AttributeError):
        pass
    merged.update(_cache)
    tmp = f"{_cache_path}.tmp.{os.getpid()}"
    payload = {"version": 1, "entries": dict(sorted(merged.items()))}
    d = os.path.dirname(_cache_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, _cache_path)


def candidates(kind: str, *, b: int, m: int, k: int, n: int,
               precision: str) -> list[dict]:
    """The launch choices worth timing for this kernel kind and shape, the
    default first (so a tie keeps the untuned launch)."""
    if kind == "fused":
        return [{"pipeline": "blocks"}, {"pipeline": "dma"}]
    if kind == "fused_batched":
        return [dict(_DEFAULTS[kind])]
    if kind == "assign":
        return [{"ctas_per_sm": c} for c in (2, 1, 4)]
    raise ValueError(f"unknown autotune kind {kind!r}")


def _time(run: Callable[[], object], device_clock: bool) -> float:
    """Best seconds a run of ``_REPS`` reps after ``_WARMUP`` runs: on a
    card (``device_clock``) by CUDA events around ``_LAUNCHES``
    back-to-back launches, so the card never waits for the host, else by
    the host clock around one call."""
    if not device_clock:
        for _ in range(_WARMUP):
            run()                              # first use + warm caches
        best = float("inf")
        for _ in range(_REPS):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best
    import torch

    for _ in range(_WARMUP):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(_REPS):
        start.record()
        for _ in range(_LAUNCHES):
            run()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3 / _LAUNCHES)
    return best


def _cuda_available() -> bool:
    import torch
    return torch.cuda.is_available()


def get_blocks(
    kind: str,
    bench_factory: Callable[[dict], Callable[[], object]] | None = None,
    *,
    backend: str,
    b: int,
    m: int,
    k: int,
    n: int,
    precision: str,
) -> dict:
    """The launch choice ``ops`` should use for this kernel kind and shape.

    Resolution order: in-process cache -> on-disk cache -> (when tuning is
    enabled and a ``bench_factory`` is given) time the candidates once and
    cache the winner -> the defaults.  ``bench_factory(blocks)`` must
    return a zero-argument callable that launches the kernel; for a card's
    backend (``cuda-*``, with a card present) it is timed by CUDA events
    around back-to-back launches, else by the host clock around the call.  A
    candidate whose bench raises makes this raise ``RuntimeError`` naming
    it.
    """
    key = cache_key(kind, backend=backend, b=b, m=m, k=k, n=n,
                    precision=precision)
    with _lock:
        load_disk()
        hit = _cache.get(key)
    if hit is not None:
        return dict(hit)
    if not _enabled or bench_factory is None:
        return dict(_DEFAULTS[kind])

    device_clock = backend.startswith("cuda-") and _cuda_available()
    best_blocks, best_t = dict(_DEFAULTS[kind]), float("inf")
    for blocks in candidates(kind, b=b, m=m, k=k, n=n, precision=precision):
        try:
            t = _time(bench_factory(blocks), device_clock)
        except Exception as exc:
            raise RuntimeError(
                f"autotune candidate {blocks} for {key} failed: "
                f"{type(exc).__name__}: {exc}") from exc
        _timings.append((key, dict(blocks), t))
        if t < best_t:
            best_blocks, best_t = blocks, t
    with _lock:
        _cache[key] = dict(best_blocks)
        _save_disk()
    return dict(best_blocks)
