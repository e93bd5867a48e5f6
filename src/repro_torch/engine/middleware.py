"""Accept-loop middleware: capabilities that wrap the stream loop.

The reference's ``repro.engine.middleware``: each capability is a
:class:`Middleware` with narrow hooks, and a :class:`MiddlewareStack`
composes them around the loop.  Hook order per window: ``transform_chunk``
(as chunks arrive) → ``after_window`` (incumbent advanced) →
``should_stop``.  The stack calls hooks in list order.

Ported here: fetch-failure skipping (:class:`FetchSkip`), the chunk
sanitizer (:class:`ChunkSanitizer`), the chunk-size VNS ladder
(:class:`VNSLadder`), progress tracing (:class:`TraceLog`), the
wall-clock budget (:class:`TimeBudget`), the post-accept invariants
(:class:`InvariantGuard`) and the loop-state checkpoint
(:class:`Checkpoint`, on :mod:`repro_torch.cluster.checkpoint`).

The sanitizer, the guard and the trace each read the device once per
window (a finiteness test, ``f_best``): they are the loop's semantics, and
the reference reads the same values.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.cluster import checkpoint as ckpt_lib
from repro_torch.engine import faults


@dataclasses.dataclass
class EngineContext:
    """Mutable per-run state threaded through every hook.

    ``state`` is the incumbent (one ``BigMeansState``, or the reduced view
    of the persistent streams); ``info`` the latest window's
    ``ChunkInfo``; ``rung`` / ``stall`` / ``last_s`` the VNS loop state
    (``last_s``: the size of the latest chunk, since objectives are sums
    over its points); ``start_step`` the chunk the run started from (a
    restored checkpoint's step, else 0); ``rng`` the key-tree backend,
    whose codec turns ``key`` into the checkpoint's ``uint32[2]`` leaf.
    """

    cfg: Any
    key: Any
    metrics: Any
    state: Any = None
    info: Any = None
    step: int = 0                   # chunks done
    start_step: int = 0
    last_cid: int = -1
    batch_len: int = 0
    t0: float = 0.0
    rung: int = 0
    stall: int = 0
    last_s: int = 0
    stop_reason: str | None = None
    rng: Any = rnd.TORCH
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

    def find(self, cls):
        for m in self.middlewares:
            if isinstance(m, cls):
                return m
        return None

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


class TimeBudget(Middleware):
    """The paper's ``cpu_max`` stop condition: stop once ``budget_s``
    seconds of ``time.monotonic()`` have passed since the run's ``t0``."""

    def __init__(self, budget_s: float):
        self.budget_s = budget_s

    def should_stop(self, ctx) -> bool:
        return time.monotonic() - ctx.t0 > self.budget_s


class VNSLadder(Middleware):
    """Chunk-size variable-neighbourhood shaking (§6 extension): a stall of
    ``patience`` unaccepted chunks escalates to the next (smaller) rung;
    any acceptance resets to the base neighbourhood.  The accept count is
    one host read a window."""

    def __init__(self, s: int, ladder, patience: int):
        self.ladder = (s,) + tuple(ladder)
        self.patience = patience

    def transform_chunk(self, ctx, cid, chunk):
        s_now = self.ladder[ctx.rung]
        if chunk.shape[0] > s_now:
            chunk = chunk[:s_now]           # VNS: shrink the neighbourhood
        return chunk

    def after_window(self, ctx):
        accepted = ctx.info.accepted
        if int(torch.sum(accepted)):
            ctx.rung, ctx.stall = 0, 0      # success -> base neighbourhood
        elif len(self.ladder) > 1:
            ctx.stall += int(accepted.numel())
            if ctx.stall >= self.patience:
                ctx.rung = min(ctx.rung + 1, len(self.ladder) - 1)
                ctx.stall = 0


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


class Checkpoint(Middleware):
    """Persist the *full* loop state: ``((state, key), vns_aux)`` where
    ``vns_aux = [rung, stall, last_s]`` — the reference's seven leaves
    (``f32[k,n]``, ``bool[k]``, ``f32[]``, ``i32[]``, ``f32[]``,
    ``u32[2]``, ``i64[3]``), the key through the backend's codec.

    ``last_s`` makes the post-resume objective rescale exact (objectives are
    sums over the chunk's points), and ``(rung, stall)`` resumes the VNS
    ladder where it stopped.  Checkpoints without the aux leaf (the legacy
    ``(state, key)`` payload) restore with the ladder reset to the base
    rung.  Each :meth:`after_window` save (from the device read to
    ``os.replace``) and each restore is timed into
    ``ctx.metrics.checkpoint``.
    """

    def __init__(self, directory: str, every: int, batch: int):
        self.directory = directory
        self.every = every
        self.batch = batch

    def _payload(self, ctx):
        aux = np.asarray([ctx.rung, ctx.stall, ctx.last_s], dtype=np.int64)
        return ((ctx.state, ctx.rng.key_to_array(ctx.key)), aux)

    def maybe_restore(self, ctx, example_state) -> bool:
        """Restore the newest *intact* checkpoint into ``ctx`` (state, key,
        step and VNS loop state); no-op when the directory holds none.

        Self-healing: a corrupt newest ``step_*`` falls back to the newest
        intact one, recorded as a ``("ckpt_fallback", step)`` trace event;
        when every stored checkpoint is corrupt the run restarts fresh with
        ``("ckpt_fallback", None)`` instead of crashing.  The state comes
        back on ``example_state``'s device.
        """
        t0 = time.perf_counter()
        latest = ckpt_lib.latest_step(self.directory)
        if latest is None:
            return False
        step = ckpt_lib.latest_intact_step(self.directory)
        if step is None:
            ctx.metrics.trace.append(("ckpt_fallback", None))
            return False
        if step != latest:
            ctx.metrics.trace.append(("ckpt_fallback", step))
        key = ctx.rng.key_to_array(ctx.key)
        example_new = ((example_state, key), np.zeros(3, dtype=np.int64))
        n = ckpt_lib.n_leaves(self.directory, step)
        if n == len(ckpt_lib.flatten(example_new)[0]):
            ((state, key), aux), step = ckpt_lib.restore(
                self.directory, example_new, step=step)
            ctx.rung, ctx.stall = int(aux[0]), int(aux[1])
            ctx.last_s = int(aux[2])
        else:                       # legacy (state, key) checkpoint
            (state, key), step = ckpt_lib.restore(
                self.directory, (example_state, key), step=step)
        ctx.state, ctx.key = state, ctx.rng.key_from_array(key)
        ctx.step = ctx.start_step = step
        ctx.metrics.checkpoint["restore_ms"].append(
            1e3 * (time.perf_counter() - t0))
        return True

    def after_window(self, ctx):
        if (ctx.last_cid + 1) % self.every < self.batch:
            t0 = time.perf_counter()
            ckpt_lib.save(self.directory, ctx.last_cid + 1,
                          self._payload(ctx))
            ctx.metrics.checkpoint["save_ms"].append(
                1e3 * (time.perf_counter() - t0))

    def on_finish(self, ctx):
        ckpt_lib.save(self.directory, ctx.step, self._payload(ctx))


def load_loop_state(directory: str):
    """Debug/test helper: the VNS aux payload of the latest checkpoint, as
    ``{'rung', 'stall', 'last_s'}`` (None for legacy checkpoints)."""
    step = ckpt_lib.latest_step(directory)
    if step is None:
        return None
    n = ckpt_lib.n_leaves(directory, step)
    with np.load(os.path.join(
            directory, f"step_{step:012d}", "arrays.npz")) as data:
        aux = data[f"a{n - 1}"]             # the aux leaf flattens last
    if aux.shape != (3,):
        return None
    return {"rung": int(aux[0]), "stall": int(aux[1]), "last_s": int(aux[2])}


def default_stack(cfg) -> MiddlewareStack:
    """The streaming runner's capability set, in the reference's order:
    fetch skipping, the sanitizer (chunk admission) before VNS (policy),
    then the observers (trace, checkpoint), the time budget, and the
    invariant guard last.  ``cfg.validate_chunks=False`` drops the
    sanitizer and the guard."""
    validate = getattr(cfg, "validate_chunks", True)
    mws: list[Middleware] = [FetchSkip()]
    if validate:
        mws.append(ChunkSanitizer())
    if cfg.vns_ladder:
        mws.append(VNSLadder(cfg.s, cfg.vns_ladder, cfg.vns_patience))
    if cfg.log_every:
        mws.append(TraceLog(cfg.log_every, cfg.batch))
    if cfg.ckpt_dir:
        mws.append(Checkpoint(cfg.ckpt_dir, cfg.ckpt_every, cfg.batch))
    if cfg.time_budget_s is not None:
        mws.append(TimeBudget(cfg.time_budget_s))
    if validate:
        mws.append(InvariantGuard())
    return MiddlewareStack(mws)
