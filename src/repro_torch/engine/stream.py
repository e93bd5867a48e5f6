"""The out-of-core accept loop: the streaming strategy's host loop.

Chunks are *fetched* by a provider (memmap slice, user callable, chunk
iterator), staged onto the device through a prefetch pipeline, and fed to
``chunk_step`` / ``chunk_step_batched`` (kernels A·, D·, B·, C· on the
card).  Capabilities (tracing, fetch-failure skip, chunk sanitizing, the
VNS ladder, checkpoints, the time budget, invariants) come from the
middleware stack, not from the loop body.  The reference's
``repro.engine.stream``: on one device, with a
:class:`~repro_torch.engine.topology.StreamMesh` (each batched step's
streams split into groups, each group advanced on its mesh device), or as
one rank of a host mesh (``host=``: a
:class:`repro_torch.engine.hostmesh.HostExchanger` owns the rank's
chunk-id shard and the cross-host exchanges).

* **resume** — with a :class:`~repro_torch.engine.middleware.Checkpoint`
  in the stack and ``resume=True``, the newest intact checkpoint is
  restored (state, key, VNS loop state) before anything reads the key or
  the chunk ids; the run continues from its step.  In fold mode a resumed
  run is bitwise the uninterrupted one.

* **fault tolerance** — a failed fetch is skipped and accounted
  (``chunks_failed``; bounded retries with deterministic backoff, a fetch
  watchdog); a chunk with unusable data is quarantined by the sanitizer.
  Only the provider's own exceptions (and the watchdog's ``FetchTimeout``)
  are fetch failures: an error while staging a chunk onto the device ends
  the run.  (The reference retries its ``device_put`` with the fetch; a
  device fault must not be counted away as a lost chunk.)
* **replay invariance** — per-chunk keys are ``rng.fold_in(key,
  chunk_id)``: batch sizes and prefetch depths replay the identical run.
* **pipelining** — a worker thread fetches chunks into a bounded queue
  and stages them on the card: through a ring of pinned host buffers, on
  a copy stream of its own, each copy closed by an event that the
  consumer's stream waits on.  Under ``precision='bf16'`` the worker casts
  to bf16 on the host (torch's round-to-nearest-even, the bits of the
  reference's ``ml_dtypes`` cast) and ships half the bytes; under
  ``'int8'`` it quantizes on the host (per-feature scales), ships int8
  codes and one f32 scale row, and dequantizes on the copy stream
  (``q.float() * scale``), so the consumer sees the reference's
  dequantized f32 chunk.

Two stream-state modes share the loop:

* **fold** (``sync_every=1``): one incumbent; each batch broadcasts it into
  B streams, steps, and argmin-reduces back.  The VNS ladder re-sizes its
  chunks.
* **persistent streams** (``batch > 1``, ``sync_every != 1``, and the
  ``competitive_s`` scheduler): B incumbents persist across batches and
  exchange only at sync boundaries — the paper's ``batch=8,
  sync_every=2``, and the sample-size race of arXiv:2403.18766, whose
  streams are scored on a common evaluation chunk (kernel B, or B16 on a
  bf16 chunk, once per stream and scoring).
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core import bigmeans
from repro_torch.engine import faults
from repro_torch.engine import middleware as mw
from repro_torch.engine import scheduler as sched_lib
from repro_torch.engine import sync as sync_lib
from repro_torch.engine import topology as topo_lib
from repro_torch.kernels import precision as px

ChunkProvider = Callable[[int], np.ndarray]


class EndOfStream(Exception):
    """Raised by a provider to end the run cleanly before ``n_chunks``
    (e.g. a finite chunk iterator ran dry).  Not counted as a failure."""


@dataclasses.dataclass
class RunnerMetrics:
    """``trace`` holds ``(chunk_id, f_best, f_new)`` progress entries plus
    the structured events: ``("fetch_error", chunk_id, "ExcType:
    message")`` for failed fetches (retries exhausted), ``("quarantine",
    chunk_id, reason)`` for chunks that arrived with unusable data,
    ``("short_chunk", cid, rows, need)`` for ragged chunks a persistent
    stream cannot take — so ``chunks_done + chunks_failed +
    chunks_dropped + chunks_quarantined`` always reconciles with the number
    of chunks fetched.

    ``checkpoint`` times the checkpoint middleware: ``save_ms`` of each
    periodic save, ``restore_ms`` of the restore (empty without
    checkpoints).

    ``pipeline`` times the prefetch pipeline, one entry per staged chunk:
    ``fetch_ms`` (the provider call, host clock), ``stage_ms`` (host
    staging: the int8 quantization or the copy into a pinned buffer and
    the copy's launch), ``copy_ms`` (the host-to-device copy and the
    dequantization on the copy stream, by CUDA events; empty on the CPU)
    and ``wait_ms`` (the consumer blocked on the queue)."""
    chunks_done: int = 0
    chunks_failed: int = 0
    chunks_dropped: int = 0
    chunks_quarantined: int = 0
    accepted: int = 0
    lloyd_iters: int = 0
    wall_time_s: float = 0.0
    f_best: float = math.inf
    trace: list = dataclasses.field(default_factory=list)
    pipeline: dict = dataclasses.field(default_factory=lambda: {
        "fetch_ms": [], "stage_ms": [], "copy_ms": [], "wait_ms": []})
    checkpoint: dict = dataclasses.field(default_factory=lambda: {
        "save_ms": [], "restore_ms": []})
    # multi-host runs (repro_torch.engine.hostmesh): the final per-rank
    # health gather — {"rank", "processes", "winner_rank", "per_rank"}
    host: dict | None = None


class _FetchFailure:
    """A failed chunk fetch: carries the provider's exception type+message,
    its fault class and how many attempts were burned on it."""

    __slots__ = ("error", "kind", "attempts")

    def __init__(self, exc: BaseException, kind: str = faults.TRANSIENT,
                 attempts: int = 1):
        self.error = f"{type(exc).__name__}: {exc}"
        self.kind = kind
        self.attempts = attempts


def _stage_quantized(arr: np.ndarray):
    """Host half of the int8 hand-off: ``(q int8, scale f32)`` codes of a
    finite chunk (the reference's ``host_quantize``), or the chunk itself
    when it holds NaN/Inf — those must reach the sanitizer verbatim (int8
    codes would launder them into in-range garbage)."""
    if not np.isfinite(arr).all():
        return arr
    return px.host_quantize(arr)


def _identity(arr):
    return arr


class _Staged:
    """A chunk staged on the device by the worker; :meth:`take` hands it to
    the consumer's stream."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event=None):
        self.tensor = tensor
        self.event = event

    def take(self) -> torch.Tensor:
        """Called on the consumer's thread: its stream waits for the copy,
        and the caching allocator keeps the block until that stream's work
        on it is done (the block was allocated on the copy stream)."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.tensor.device)
            cur.wait_event(self.event)
            self.tensor.record_stream(cur)
        return self.tensor


class _Slot:
    """One pinned host buffer of the staging ring and the event of the last
    copy out of it."""

    __slots__ = ("buffers", "done")

    def __init__(self):
        self.buffers: list[torch.Tensor] = []
        self.done = None

    def view(self, i: int, shape, dtype: torch.dtype) -> torch.Tensor:
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        while len(self.buffers) <= i:
            self.buffers.append(torch.empty(0, dtype=torch.uint8))
        if self.buffers[i].numel() < nbytes:
            self.buffers[i] = torch.empty(nbytes, dtype=torch.uint8,
                                          pin_memory=True)
        return self.buffers[i][:nbytes].view(dtype).view(tuple(shape))


class _Stager:
    """Host -> device hand-off of one run's chunks.

    :meth:`prepare` is the host half that the reference retries with the
    fetch (the int8 quantization); :meth:`ship` stages onto the device.  On
    the card a chunk goes through a ring of pinned buffers and one copy
    stream: a buffer is refilled only after the event of the copy out of it
    has completed, so a producer that runs ahead never overwrites a chunk
    in flight.  On the CPU the chunk is copied into a tensor.
    """

    def __init__(self, device: torch.device, precision: str, stats: dict,
                 slots: int = 2):
        if device.type == "cuda" and device.index is None:
            # the worker thread sets this device: it needs the index
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.quantize = precision == "int8"
        self.dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        self.prepare = _stage_quantized if self.quantize else _identity
        self.stats = stats
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.ring = [_Slot() for _ in range(slots)]
            self.turn = 0
            self.events: list = []

    def _parts(self, prepared):
        """(host parts, their staging dtypes): codes and scales, or the
        chunk in the policy's storage."""
        if isinstance(prepared, tuple):
            return prepared, (torch.int8, torch.float32)
        return (prepared,), (self.dtype,)

    @staticmethod
    def _assemble(parts):
        if len(parts) == 2:                 # int8 codes, f32 scale row
            q, scale = parts
            return q.float() * scale[None, :]
        return parts[0]

    def ship(self, prepared) -> _Staged:
        arrays, dtypes = self._parts(prepared)
        if not self.cuda:
            staged = _Staged(self._assemble(
                [torch.tensor(a).to(d) for a, d in zip(arrays, dtypes)]))
        else:
            slot = self.ring[self.turn % len(self.ring)]
            self.turn += 1
            if slot.done is not None:
                slot.done.synchronize()     # the last copy out of it is done
            hosts = []
            for i, (a, d) in enumerate(zip(arrays, dtypes)):
                host = slot.view(i, a.shape, d)
                host.copy_(torch.from_numpy(np.require(a, requirements="W")))
                hosts.append(host)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self.stream):
                start.record()
                chunk = self._assemble(
                    [h.to(self.device, non_blocking=True) for h in hosts])
                end.record()
            slot.done = end
            self.events.append((start, end))
            staged = _Staged(chunk, end)
        return staged

    def copy_ms(self) -> list[float]:
        """Device ms of each chunk's copy (and dequantization)."""
        if not self.cuda:
            return []
        out = []
        for start, end in self.events:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out


def _fetch_resilient(provider, cid, fault_injector, *, retry=None,
                     timeout=None, wait=time.sleep, aborted=None,
                     prepare=_identity):
    """One guarded chunk fetch: watchdog + classify + bounded retry.

    Returns the host chunk after ``prepare`` (f32, or the int8 codes),
    raises :class:`EndOfStream`, or returns a :class:`_FetchFailure` once
    the fault is terminal (permanent class, or a transient one with the
    retry budget exhausted).  A hung provider becomes a retryable
    :class:`FetchTimeout` via the watchdog.
    """

    def attempt_once():
        if fault_injector is not None:
            fault_injector(cid)
        return devices.host_array(provider(cid), np.float32)

    attempt = 0
    while True:
        try:
            arr = faults.call_with_timeout(
                attempt_once, timeout, name=f"fetch-watchdog-{cid}")
            return prepare(arr)
        except EndOfStream:
            raise
        except Exception as exc:
            kind = faults.classify(exc)
            retries = retry.retries if retry is not None else 0
            if (kind == faults.TRANSIENT and attempt < retries
                    and not (aborted is not None and aborted())):
                wait(retry.delay(cid, attempt))
                attempt += 1
                continue
            return _FetchFailure(exc, kind=kind, attempts=attempt + 1)


class _Fetcher:
    """Fetch (guarded) and stage one chunk; times both."""

    def __init__(self, provider, fault_injector, stager: _Stager, *,
                 retry=None, timeout=None):
        self.provider = provider
        self.fault_injector = fault_injector
        self.stager = stager
        self.retry = retry
        self.timeout = timeout

    def __call__(self, cid, wait=time.sleep, aborted=None):
        prep_s = []

        def prepare(arr):
            t = time.perf_counter()
            out = self.stager.prepare(arr)
            prep_s.append(time.perf_counter() - t)
            return out

        t0 = time.perf_counter()
        item = _fetch_resilient(
            self.provider, cid, self.fault_injector, retry=self.retry,
            timeout=self.timeout, wait=wait, aborted=aborted,
            prepare=prepare)
        if isinstance(item, _FetchFailure):
            return item
        t1 = time.perf_counter()
        staged = self.stager.ship(item)     # a device error ends the run
        stats = self.stager.stats
        stats["fetch_ms"].append(1e3 * (t1 - t0 - sum(prep_s)))
        stats["stage_ms"].append(
            1e3 * (time.perf_counter() - t1 + sum(prep_s)))
        return staged


class _Raised:
    """An exception of the worker, re-raised on the consumer's thread."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Prefetcher:
    """Background chunk fetcher: provider call, host staging and the copy
    onto the device run off the main thread, through a bounded queue.

    Yields ``(chunk_id, chunk-or-_FetchFailure)`` in id order.  An error
    outside the provider (staging, the device) is re-raised on the
    consumer's thread and ends the run.
    """

    _DONE = object()

    def __init__(self, fetcher: _Fetcher, ids, depth: int, stats: dict):
        self._fetcher = fetcher
        self._ids = ids
        self._stats = stats
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        stager = self._fetcher.stager
        try:
            if stager.cuda:
                torch.cuda.set_device(stager.device)
            for cid in self._ids:
                if self._stop.is_set():
                    return
                try:
                    item = self._fetcher(cid, wait=self._stop.wait,
                                         aborted=self._stop.is_set)
                except EndOfStream:
                    break
                if not self._put((cid, item)):
                    return
        except Exception as exc:            # relayed to the consumer
            self._put(_Raised(exc))
            return
        self._put(self._DONE)

    def __iter__(self) -> Iterator:
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
            cid, chunk = item
            if isinstance(chunk, _Staged):
                self._stats["wait_ms"].append(
                    1e3 * (time.perf_counter() - t0))
                chunk = chunk.take()
            yield cid, chunk

    def close(self):
        self._stop.set()
        # Drain so a blocked producer can observe the stop flag and exit.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def _sync_chunks(fetcher: _Fetcher, ids):
    """prefetch=0: fetch on the main thread (debug / determinism), with the
    same retry / watchdog semantics as the prefetch pipeline."""
    for cid in ids:
        try:
            item = fetcher(cid)
        except EndOfStream:
            return
        yield cid, item.take() if isinstance(item, _Staged) else item


class _StepKernel:
    """One accept step against the chosen topology."""

    def __init__(self, cfg, key, rng, topology=None):
        self.cfg = cfg
        self.key = key
        self.rng = rng
        self.topology = topology

    def _kwargs(self):
        cfg = self.cfg
        return dict(max_iters=cfg.max_iters, tol=cfg.tol,
                    candidates=cfg.candidates, impl=cfg.impl,
                    precision=getattr(cfg, "precision", "auto"),
                    rng=self.rng)

    def keys_for(self, cids):
        # Per-chunk keys are folded from (seed, chunk_id): batch sizes and
        # prefetch depths replay the identical sample stream.
        return [self.rng.fold_in(self.key, cid) for cid in cids]

    def step_one(self, chunk, state, cid):
        return bigmeans.chunk_step(
            chunk, state, self.keys_for([cid])[0], **self._kwargs())

    def step_states(self, chunks, states, cids):
        """Advance B persistent streams by their chunks (stacked [B, s, n]).
        On a stream mesh whose D groups divide B, group g (streams
        ``g*B/D .. (g+1)*B/D - 1``) steps on its mesh device; the streams
        are independent, so this is bitwise the one-device step."""
        keys = self.keys_for(cids)
        topo = self.topology
        batch = chunks.shape[0]
        if not isinstance(topo, topo_lib.StreamMesh) \
                or batch % topo.devices:
            return bigmeans.chunk_step_batched(chunks, states, keys,
                                               **self._kwargs())
        bl = batch // topo.devices
        home = chunks.device
        parts, infos = [], []
        for g, dev in enumerate(topo.group_devices()):
            sl = slice(g * bl, (g + 1) * bl)
            sub, info = bigmeans.chunk_step_batched(
                chunks[sl].to(dev),
                bigmeans.BigMeansState(*(a[sl].to(dev) for a in states)),
                keys[sl], **self._kwargs())
            parts.append(sub)
            infos.append(info)
        states = bigmeans.BigMeansState(
            *(torch.cat([f.to(home) for f in field]) for field in zip(*parts)))
        info = bigmeans.ChunkInfo(
            *(torch.cat([f.to(home) for f in field]) for field in zip(*infos)))
        return states, info

    def step_fold(self, state, pending):
        """Advance one incumbent by len(pending) concurrent chunk streams."""
        if len(pending) == 1:
            return self.step_one(pending[0][1], state, pending[0][0])
        chunks = torch.stack([c for _, c in pending])
        states = bigmeans.broadcast_state(state, len(pending))
        states, info = self.step_states(
            chunks, states, [cid for cid, _ in pending])
        return bigmeans.reduce_state(states, base=state), info


def run_stream(
    provider: ChunkProvider,
    cfg,
    *,
    n_features: int,
    resume: bool = True,
    fault_injector: Callable[[int], None] | None = None,
    key=None,
    middlewares=None,
    topology=None,
    scheduler=None,
    sync=None,
    host=None,
    rng=rnd.TORCH,
    device=None,
) -> tuple[bigmeans.BigMeansState, RunnerMetrics]:
    """Stream chunks through Big-means until the chunk count or a middleware
    stop condition ends the run.

    ``cfg`` is a :class:`repro_torch.api.BigMeansConfig` (or anything with
    the same fields).  ``middlewares`` / ``topology`` / ``scheduler`` /
    ``sync`` default to the config's
    (:func:`repro_torch.engine.middleware.default_stack`,
    :func:`repro_torch.engine.topology.for_streams`, ``cfg.scheduler``,
    ``cfg.sync`` / ``cfg.sync_every``).  ``key``
    defaults to ``rng.key(cfg.seed)``.  Runs on the CUDA device unless
    ``device="cpu"``.  With ``resume`` and a checkpoint middleware in the
    stack (``cfg.ckpt_dir``), the run restores the newest intact
    checkpoint and continues from its step.

    ``vns_ladder`` needs the fold mode (collective sync), and the
    ``competitive_s`` scheduler runs the persistent-stream mode, whatever
    ``sync_every`` says.

    ``host`` plugs in a :class:`repro_torch.engine.hostmesh.HostExchanger`
    for multi-host runs: it owns this rank's chunk-id shard, the
    cross-host incumbent exchange at sync windows, and the final
    argmin-reduce.  With ``host=None`` (every single-process run) the loop
    body is untouched.
    """
    dev = devices.resolve(device)
    if key is None:
        key = rng.key(cfg.seed)
    scheduler = scheduler if scheduler is not None else \
        sched_lib.get_scheduler(getattr(cfg, "scheduler", "uniform"), cfg)
    sync = sync if sync is not None else sync_lib.from_config(cfg)
    topology = topology if topology is not None else \
        topo_lib.for_streams(cfg, dev)
    if isinstance(topology, topo_lib.WorkerMesh):
        raise ValueError(
            "the stream loop parallelizes over the stream axis; use "
            "StreamMesh (or the 'sharded' strategy for worker meshes)")
    if isinstance(topology, topo_lib.HostMesh) and host is None:
        raise ValueError(
            "host_mesh runs go through repro_torch.engine.hostmesh."
            "run_host_stream (or fit(), which routes there): the stream "
            "loop needs the exchanger's chunk-id shard and sync hooks")
    if middlewares is None:
        stack = mw.default_stack(cfg)
    elif isinstance(middlewares, mw.MiddlewareStack):
        stack = middlewares
    else:
        stack = mw.MiddlewareStack(middlewares)
    competitive_sched = isinstance(scheduler, sched_lib.CompetitiveS)
    persistent = competitive_sched or (cfg.batch > 1 and sync.every != 1)
    if persistent and cfg.vns_ladder:
        raise ValueError(
            "vns_ladder requires collective sync (sync_every=1): the ladder "
            "re-sizes the single incumbent's chunks, which is incompatible "
            "with persistent per-stream incumbents")
    if competitive_sched and isinstance(topology, topo_lib.StreamMesh):
        raise ValueError(
            "competitive_s schedules ragged per-stream chunk sizes, which "
            "cannot shard over a stream mesh; use the single-device "
            "topology")

    state = bigmeans.init_state(cfg.k, n_features, device=dev)
    metrics = RunnerMetrics()
    ctx = mw.EngineContext(cfg=cfg, key=key, metrics=metrics, state=state,
                           t0=time.monotonic(), last_s=cfg.s, rng=rng)
    ckpt = stack.find(mw.Checkpoint)
    if resume and ckpt is not None:
        ckpt.maybe_restore(ctx, state)
        state, key = ctx.state, ctx.key
    start_chunk = ctx.start_step
    if host is not None:
        # collective start: every rank adopts rank 0's restored
        # (state, key, step) so the fleet resumes the same global window
        state, key, start_chunk = host.sync_start(ctx, state, key)
    metrics.f_best = float(torch.min(state.f_best))

    stager = _Stager(dev, getattr(cfg, "precision", "auto"),
                     metrics.pipeline)
    fetcher = _Fetcher(provider, fault_injector, stager,
                       retry=faults.RetryPolicy.from_config(cfg),
                       timeout=getattr(cfg, "fetch_timeout_s", None))
    ids = (host.chunk_ids(start_chunk) if host is not None
           else range(start_chunk, cfg.n_chunks))
    source = (_Prefetcher(fetcher, ids, cfg.prefetch, metrics.pipeline)
              if cfg.prefetch > 0 else _sync_chunks(fetcher, ids))
    kernel = _StepKernel(cfg, key, rng, topology)
    ctx.extras["stream_mode"] = "persistent" if persistent else "fold"
    stack.on_start(ctx)

    runner_fn = _run_persistent if persistent else _run_fold
    try:
        state = runner_fn(source, state, ctx, stack, kernel, scheduler, sync,
                          host)
    finally:
        if isinstance(source, _Prefetcher):
            source.close()
    metrics.pipeline["copy_ms"] = stager.copy_ms()

    ctx.state = state
    ctx.step = start_chunk + metrics.chunks_done
    if host is not None:
        # final cross-host argmin-reduce + counter merge + health gather;
        # a dead peer surfaces here as a typed HostDead, never a hang
        state = host.finalize(ctx, state)
        ctx.state = state
        ctx.step = host.global_step
    stack.on_finish(ctx)
    metrics.wall_time_s = time.monotonic() - ctx.t0
    metrics.f_best = float(torch.min(state.f_best))
    return state, metrics


def _drop_pending(ctx, pending):
    """Stop accounting for fetched-but-unstepped chunks (so done + failed
    + dropped + quarantined reconciles with fetched)."""
    if pending:
        ctx.metrics.chunks_dropped += len(pending)
        ctx.metrics.trace.append(
            ("budget_drop", tuple(cid for cid, _ in pending)))


def _sanitize(ctx, stack, chunk_id, chunk):
    """Run the middleware transform chain; a quarantined chunk is counted
    and traced, and ``None`` is returned so the loop skips it."""
    try:
        return stack.transform_chunk(ctx, chunk_id, chunk)
    except faults.ChunkQuarantined as q:
        ctx.metrics.chunks_quarantined += 1
        ctx.metrics.trace.append(("quarantine", chunk_id, q.reason))
        return None


def _consume_info(ctx, info):
    m = ctx.metrics
    m.accepted += int(torch.sum(info.accepted))
    m.lloyd_iters += int(torch.sum(info.lloyd_iters))


def _account_stopped(ctx, stack, chunk_id, chunk, pending):
    """The item in hand when a stop condition fired was already consumed
    from the source: account for it (failed or dropped), never lose it."""
    if isinstance(chunk, _FetchFailure):
        stack.on_fetch_error(ctx, chunk_id, chunk.error)
    elif chunk is None:
        ctx.metrics.chunks_failed += 1
    else:
        pending.append((chunk_id, chunk))


def _admit(ctx, stack, chunk_id, chunk):
    """The chunk after the failure accounting and the sanitizer, or None
    when the loop must skip it."""
    if chunk is None or isinstance(chunk, _FetchFailure):
        if isinstance(chunk, _FetchFailure):
            stack.on_fetch_error(ctx, chunk_id, chunk.error)
        else:
            ctx.metrics.chunks_failed += 1
        return None
    return _sanitize(ctx, stack, chunk_id, chunk)


def _run_fold(source, state, ctx, stack, kernel, scheduler, sync, host=None):
    """Collective mode: one incumbent, argmin-reduced after every batch."""
    cfg = ctx.cfg
    metrics = ctx.metrics
    pending: list = []

    def flush(state):
        state, info = kernel.step_fold(state, pending)
        metrics.chunks_done += len(pending)
        ctx.last_cid = pending[-1][0]
        pending.clear()
        _consume_info(ctx, info)
        if host is not None:
            # cross-host exchange BEFORE after_window, so the (rank-0)
            # checkpoint holds the post-exchange global incumbent at the
            # global chunk frontier
            state = host.fold_boundary(ctx, state)
        ctx.state, ctx.info = state, info
        ctx.step = (host.global_step if host is not None
                    else ctx.start_step + metrics.chunks_done)
        stack.after_window(ctx)
        return state

    stopped = False
    for chunk_id, chunk in source:
        if stack.should_stop(ctx):
            stopped = True
            _account_stopped(ctx, stack, chunk_id, chunk, pending)
            break
        chunk = _admit(ctx, stack, chunk_id, chunk)
        if chunk is None:
            continue
        if pending and chunk.shape != pending[0][1].shape:
            # ragged chunk (short tail / VNS rung change mid-batch): flush
            # the homogeneous batch first, then start a new one
            state = flush(state)
        if chunk.shape[0] != ctx.last_s and math.isfinite(
                float(state.f_best)):
            # objectives are sums over s points: rescale the incumbent's
            # objective so acceptance compares per-point quality
            state = state._replace(
                f_best=state.f_best * (chunk.shape[0] / ctx.last_s))
        ctx.last_s = chunk.shape[0]
        pending.append((chunk_id, chunk))
        if len(pending) < cfg.batch:
            continue
        state = flush(state)
        if stack.should_stop(ctx):
            stopped = True
            break
    else:
        if pending:                     # final partial batch
            state = flush(state)
    if stopped:
        _drop_pending(ctx, pending)
    return state


def _run_persistent(source, state, ctx, stack, kernel, scheduler, sync,
                    host=None):
    """Persistent-stream mode: B incumbents advance across batches and
    exchange only at sync boundaries (periodic / competitive modes, and the
    ``competitive_s`` sample-size race)."""
    cfg = ctx.cfg
    metrics = ctx.metrics
    B = cfg.batch
    base = state                        # restored counters live here
    states = bigmeans.broadcast_state(state, B)
    sizes = list(scheduler.sizes(B))
    if any(s is None for s in sizes):
        sizes = [cfg.s] * B
    round_idx = 0
    pending: list = []
    competitive_sched = isinstance(scheduler, sched_lib.CompetitiveS)
    eval_chunk = None                   # last admitted chunk (common eval)

    def stream_scores(states) -> np.ndarray:
        """Every incumbent scored on the SAME evaluation chunk — chunk
        objectives at different sizes are not comparable (small chunks
        overfit), a shared eval set is.  One assignment a stream (kernel
        B, or B16 on a bf16 chunk), all read at once, in float64 on the
        host."""
        from repro_torch.core.objective import chunk_objective

        return torch.stack([chunk_objective(eval_chunk, c, impl=cfg.impl)
                            for c in states.centroids]).cpu().numpy(
                            ).astype(np.float64)

    def stream_slices(pending):
        """Assign this round's chunks to streams 0..len(pending)-1 and
        group them by that stream's chunk size.  A chunk too short for its
        stream (ragged tail of a finite source) is skipped — chunks are
        i.i.d. samples — and returned for accounting."""
        groups: dict[int, list] = {}
        skipped: list = []
        for b, (cid, chunk) in enumerate(pending):
            s_b = sizes[b]
            if chunk.shape[0] < s_b:
                skipped.append((cid, int(chunk.shape[0]), s_b))
                continue
            groups.setdefault(s_b, []).append((b, cid, chunk[:s_b]))
        return groups, skipped

    def step_round(states, pending):
        groups, skipped = stream_slices(pending)
        for cid, rows, need in skipped:
            metrics.chunks_dropped += 1
            metrics.trace.append(("short_chunk", cid, rows, need))
        for s_b, members in sorted(groups.items()):
            idx = torch.tensor([b for b, _, _ in members],
                               device=states.f_best.device)
            chunks = torch.stack([c for _, _, c in members])
            sub = bigmeans.BigMeansState(*(a[idx] for a in states))
            sub, info = kernel.step_states(
                chunks, sub, [cid for _, cid, _ in members])
            states = bigmeans.BigMeansState(
                *(a.index_copy(0, idx, u) for a, u in zip(states, sub)))
            _consume_info(ctx, info)
            ctx.info = info
        metrics.chunks_done += len(pending) - len(skipped)
        ctx.last_cid = pending[-1][0]
        return states

    def reduce(states):
        """Keep-the-best across streams.  At uniform sizes the argmin of
        ``f_best`` per point, in float64 on the host (first stream wins a
        tie); under competitive_s the incumbents are scored on the common
        eval chunk (raw objectives are size-incomparable)."""
        if competitive_sched and eval_chunk is not None:
            w = int(np.argmin(stream_scores(states)))
        else:
            f = states.f_best.cpu().numpy().astype(np.float64)
            w = int(np.argmin(f / np.asarray(sizes, dtype=np.float64)))
        ctx.extras["winner_s"] = int(sizes[w])
        return bigmeans.BigMeansState(
            centroids=states.centroids[w],
            degenerate=states.degenerate[w],
            f_best=states.f_best[w],
            n_accepted=(torch.sum(states.n_accepted)
                        + base.n_accepted).to(torch.int32),
            n_dist_evals=torch.sum(states.n_dist_evals) + base.n_dist_evals,
        )

    def clone(states, b: int, src: int, f_best):
        """Stream ``b`` adopts stream ``src``'s incumbent, with ``f_best``
        as given."""
        c, deg, f = (t.clone() for t in states[:3])
        c[b], deg[b], f[b] = c[src], deg[src], f_best
        return states._replace(centroids=c, degenerate=deg, f_best=f)

    def boundary(states):
        nonlocal sizes
        if (round_idx + 1) % cfg.sync_every == 0:
            # scheduler observation window: competitive_s scores every
            # incumbent on the shared eval chunk and reallocates here
            if competitive_sched and eval_chunk is not None:
                scores = stream_scores(states).tolist()
            else:
                scores = states.f_best.cpu().numpy().tolist()
            moves = scheduler.observe_window(scores, list(sizes))
            for b, new_s, clone_from in moves:
                ratio = new_s / sizes[clone_from]
                states = clone(states, b, clone_from,
                               states.f_best[clone_from] * ratio)
            sizes = list(scheduler.sizes(B))
        if sync.boundary(round_idx):
            if competitive_sched and eval_chunk is not None:
                # cross-size collective exchange: every stream continues
                # from the eval winner, acceptance threshold rescaled to
                # its own chunk size (same per-point quality)
                scores = stream_scores(states)
                w = int(np.argmin(scores))
                s_eval = eval_chunk.shape[0]
                dev = states.f_best.device
                ratios = torch.tensor([s_b / s_eval for s_b in sizes],
                                      dtype=torch.float32, device=dev)
                states = states._replace(
                    centroids=states.centroids[w].expand_as(
                        states.centroids).contiguous(),
                    degenerate=states.degenerate[w].expand_as(
                        states.degenerate).contiguous(),
                    f_best=torch.tensor(scores[w], dtype=torch.float32,
                                        device=dev) * ratios,
                )
            elif len(set(sizes)) == 1:
                # periodic argmin exchange (comparable only at equal sizes)
                states = bigmeans._sync_streams(states)
        return states

    stopped = False
    for chunk_id, chunk in source:
        if stack.should_stop(ctx):
            stopped = True
            _account_stopped(ctx, stack, chunk_id, chunk, pending)
            break
        chunk = _admit(ctx, stack, chunk_id, chunk)
        if chunk is None:               # quarantined: never the eval set
            continue
        eval_chunk = chunk              # raw (unsliced): the common eval set
        pending.append((chunk_id, chunk))
        if len(pending) < B:
            continue
        states = step_round(states, pending)
        pending = []
        if host is None:
            ctx.state = reduce(states)
            ctx.step = ctx.start_step + metrics.chunks_done
            stack.after_window(ctx)
            states = boundary(states)
        else:
            # host order: local boundary (observe + local sync) first, then
            # the cross-host exchange, and only then checkpoint — so the
            # rank-0 checkpoint holds the post-exchange global state at the
            # global window frontier
            states = boundary(states)
            states = host.persistent_boundary(ctx, states, sizes)
            ctx.state = reduce(states)
            ctx.step = host.global_step
            stack.after_window(ctx)
        round_idx += 1
        if stack.should_stop(ctx):
            stopped = True
            break
    else:
        if pending:                     # final partial round
            states = step_round(states, pending)
            pending = []
            ctx.state = reduce(states)
            ctx.step = (host.global_step if host is not None
                        else ctx.start_step + metrics.chunks_done)
            stack.after_window(ctx)
    if stopped:
        _drop_pending(ctx, pending)
    return reduce(states)
