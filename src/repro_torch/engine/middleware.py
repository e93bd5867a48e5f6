"""Accept-loop middleware: capabilities that wrap the stream loop.

The reference's ``repro.engine.middleware``: each capability is a
:class:`Middleware` with narrow hooks, and a :class:`MiddlewareStack`
composes them around the loop.  Hook order per window: ``transform_chunk``
(as chunks arrive) → ``after_window`` (incumbent advanced) →
``should_stop``.  The stack calls hooks in list order.

Ported here: fetch-failure skipping (:class:`FetchSkip`), the chunk
sanitizer (:class:`ChunkSanitizer`), progress tracing (:class:`TraceLog`)
and the post-accept invariants (:class:`InvariantGuard`).  ``TimeBudget``
and ``VNSLadder`` come with queue 1 item 6b, ``Checkpoint`` with item 6c;
the config rejects their knobs until then.

The sanitizer, the guard and the trace each read the device once per
window (a finiteness test, ``f_best``): they are the loop's semantics, and
the reference reads the same values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.engine import faults


@dataclasses.dataclass
class EngineContext:
    """Mutable per-run state threaded through every hook.

    ``state`` is the incumbent (one ``BigMeansState``, or the reduced view
    of the persistent streams); ``info`` the latest window's
    ``ChunkInfo``; ``last_s`` the size of the latest chunk (objectives are
    sums over its points).
    """

    cfg: Any
    key: Any
    metrics: Any
    state: Any = None
    info: Any = None
    step: int = 0                   # chunks done
    last_cid: int = -1
    t0: float = 0.0
    last_s: int = 0
    stop_reason: str | None = None
    extras: dict = dataclasses.field(default_factory=dict)


class Middleware:
    """Base class: every hook is a no-op."""

    def on_start(self, ctx: EngineContext) -> None:
        pass

    def transform_chunk(self, ctx: EngineContext, cid: int, chunk):
        return chunk

    def on_fetch_error(self, ctx: EngineContext, cid: int, err: str) -> None:
        pass

    def after_window(self, ctx: EngineContext) -> None:
        pass

    def should_stop(self, ctx: EngineContext) -> bool:
        return False

    def on_finish(self, ctx: EngineContext) -> None:
        pass


class MiddlewareStack:
    def __init__(self, middlewares):
        self.middlewares = list(middlewares)

    def __iter__(self):
        return iter(self.middlewares)

    def on_start(self, ctx):
        for m in self.middlewares:
            m.on_start(ctx)

    def transform_chunk(self, ctx, cid, chunk):
        for m in self.middlewares:
            chunk = m.transform_chunk(ctx, cid, chunk)
        return chunk

    def on_fetch_error(self, ctx, cid, err):
        for m in self.middlewares:
            m.on_fetch_error(ctx, cid, err)

    def after_window(self, ctx):
        for m in self.middlewares:
            m.after_window(ctx)

    def should_stop(self, ctx) -> bool:
        for m in self.middlewares:
            if m.should_stop(ctx):
                if ctx.stop_reason is None:
                    ctx.stop_reason = type(m).__name__
                return True
        return False

    def on_finish(self, ctx):
        for m in self.middlewares:
            m.on_finish(ctx)


class TraceLog(Middleware):
    """``(chunk_id, f_best, f_new)`` progress entries when the chunks done
    cross a multiple of ``every`` (within one batch of it)."""

    def __init__(self, every: int, batch: int):
        self.every = every
        self.batch = batch

    def after_window(self, ctx):
        m = ctx.metrics
        if ctx.info is None:            # window where no stream stepped
            return
        if self.every and m.chunks_done % self.every < self.batch:
            m.trace.append(
                (ctx.last_cid, float(torch.min(ctx.state.f_best)),
                 float(torch.min(ctx.info.f_new))))


class FetchSkip(Middleware):
    """Account for failed fetches: chunks are i.i.d. samples, so a lost one
    is skipped but never silently — the metrics count it and the trace
    records the cause."""

    def on_fetch_error(self, ctx, cid, err):
        ctx.metrics.chunks_failed += 1
        ctx.metrics.trace.append(("fetch_error", cid, err))


class ChunkSanitizer(Middleware):
    """Validate a chunk before it can reach acceptance.

    A NaN/Inf-poisoned or wrong-shape chunk must never be compared against
    ``f_best`` (NaN comparisons silently reject, ``-inf`` silently wins):
    raise :class:`ChunkQuarantined` and let the loop account for it as
    ``("quarantine", cid, reason)`` + ``chunks_quarantined``.  The
    finiteness test runs on the device.
    """

    def transform_chunk(self, ctx, cid, chunk):
        n = int(ctx.state.centroids.shape[-1])
        if chunk.ndim != 2 or int(chunk.shape[1]) != n:
            raise faults.ChunkQuarantined(
                f"bad shape {tuple(map(int, chunk.shape))}, want (*, {n})")
        if int(chunk.shape[0]) < int(ctx.cfg.k):
            raise faults.ChunkQuarantined(
                f"chunk has {int(chunk.shape[0])} rows < k={ctx.cfg.k}")
        if not bool(torch.isfinite(chunk).all()):
            raise faults.ChunkQuarantined("non-finite values (NaN/Inf)")
        return chunk


class InvariantGuard(Middleware):
    """Post-accept invariants: ``f_best`` stays finite and, in fold mode,
    monotone non-increasing *per point*.

    Acceptance only ever lowers ``f_best``; the sole legitimate raw change
    upward is the chunk-size rescale, which preserves ``f_best / s``.  So
    the per-point incumbent must never rise — if it does (or goes NaN /
    ``-inf``), the run is corrupt and must stop loudly.  Persistent-stream
    mode tracks only finiteness.
    """

    def __init__(self, rtol: float = 1e-4):
        self.rtol = rtol
        self._best_per_point = math.inf

    def after_window(self, ctx):
        f = float(torch.min(ctx.state.f_best))
        if math.isnan(f) or f == -math.inf:
            raise faults.InvariantViolation(
                f"f_best became {f!r}: acceptance was poisoned by bad data")
        if not math.isfinite(f) or ctx.extras.get("stream_mode") != "fold":
            return
        per_point = f / max(int(ctx.last_s), 1)
        if per_point > self._best_per_point * (1.0 + self.rtol):
            raise faults.InvariantViolation(
                f"f_best per point rose: {per_point:.6e} after "
                f"{self._best_per_point:.6e} (monotone non-increasing "
                "acceptance violated)")
        self._best_per_point = min(self._best_per_point, per_point)


def default_stack(cfg) -> MiddlewareStack:
    """The streaming runner's capability set, in the reference's order:
    fetch skipping, the sanitizer (chunk admission), the trace, and the
    invariant guard last.  ``cfg.validate_chunks=False`` drops the
    sanitizer and the guard."""
    validate = getattr(cfg, "validate_chunks", True)
    mws: list[Middleware] = [FetchSkip()]
    if validate:
        mws.append(ChunkSanitizer())
    if cfg.log_every:
        mws.append(TraceLog(cfg.log_every, cfg.batch))
    if validate:
        mws.append(InvariantGuard())
    return MiddlewareStack(mws)
