"""The batching frontend: coalesce concurrent requests into one launch.

The port of the reference's ``repro.serve.batcher``.  Serving traffic is
many small point batches arriving concurrently; the kernel wants one large
launch.  Each model gets one :class:`Batcher`: a bounded queue plus a
*supervised* worker thread that

1. blocks for the first pending request,
2. lingers up to ``max_linger_ms`` pulling whole requests while they fit
   under ``max_batch`` (a request is never split across launches — one
   response always comes from exactly one launch, hence exactly one
   centroid snapshot), shedding expired or cancelled requests from the
   queue before they can waste launch capacity,
3. packs the coalesced rows into the bucket's host buffer (pinned on the
   card), zero-padded to the next power-of-two bucket (each bucket's launch
   is one CUDA graph, captured at warmup and never per request size),
4. reads the model's centroid snapshot *once*, launches (on the card: the
   rows copied asynchronously into the graph's static input, the graph
   replayed, ids and distances read back once before the next replay can
   overwrite them), and scatters the results back to each request's future
   with per-request latency accounting.

Admission is fail-fast: a full queue raises :class:`QueueFull`, a full
per-tenant quota :class:`QuotaExceeded`, an open circuit breaker
:class:`ModelUnhealthy`, a non-finite payload :class:`InvalidRequest` —
all at submit time, never by blocking the caller.

Failure is isolated, not amplified.  A launch that raises is classified
through :func:`repro_torch.engine.faults.classify`: transients retry the
same launch (:meth:`ModelEntry.relaunch`: on the card the bucket's graph
replayed, never the plain version); permanents *bisect* the batch so only
the requests actually implicated fail (their coalesced neighbors are
re-launched and served bitwise-identically to the healthy path).  A
bucket that keeps failing is demoted: on the CPU it runs the reference's
ref path, on the card it has no plain route and its requests fail with
:class:`LaunchFault`.  The worker itself runs under a supervisor: a crash fails every pending future
with :class:`WorkerCrashed` (never a stranded client), increments
``worker_restarts``, and restarts the serve loop.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.engine import faults
from repro_torch.serve.config import ServeConfig, _next_pow2
from repro_torch.serve.registry import ModelEntry
from repro_torch.serve.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    InvalidRequest,
    LaunchFault,
    ModelUnhealthy,
    QueueFull,
    QuotaExceeded,
    ServerClosed,
    WorkerCrashed,
)

__all__ = [
    "AssignResponse",
    "Batcher",
    "BatcherStats",
    "QueueFull",
    "ServerClosed",
]


@dataclass
class AssignResponse:
    """One request's results plus its serving telemetry.

    ``version`` / ``step`` identify the exact centroid snapshot that
    served this response (one snapshot per response, by construction);
    ``batch_rows`` / ``n_coalesced`` describe the launch it rode in;
    ``latency_ms`` is submit-to-completion, queueing and linger included.
    """

    ids: np.ndarray         # [m] int32 cluster ids
    dists: np.ndarray       # [m] f32 squared distances
    model_id: str
    version: int
    step: int | None
    latency_ms: float
    batch_rows: int         # padded bucket rows of the launch
    n_coalesced: int        # requests coalesced into the launch


class _Request:
    __slots__ = ("points", "future", "t_submit", "deadline", "tenant")

    def __init__(self, points: np.ndarray, *, deadline: float | None = None,
                 tenant: str = "default"):
        self.points = points
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline           # absolute monotonic, or None
        self.tenant = tenant


class BatcherStats:
    """Mutable per-model serving counters (snapshot via ``to_dict``).

    Latency percentiles only ever see requests that completed with a
    result: cancelled, shed, rejected and failed requests are counted in
    their own counters and excluded — a client that gave up must not
    drag the percentiles it never observed.
    """

    def __init__(self, maxlen: int = 20000):
        self.lock = threading.Lock()
        self.latencies_ms = collections.deque(maxlen=maxlen)
        self.n_requests = 0
        self.n_rejected = 0          # QueueFull
        self.n_quota_rejected = 0    # QuotaExceeded (per-tenant)
        self.n_breaker_rejected = 0  # ModelUnhealthy fast-fails
        self.n_invalid = 0           # non-finite payloads (InvalidRequest)
        self.n_cancelled = 0         # client gave up (assign timeout)
        self.n_deadline_shed = 0     # expired in queue (DeadlineExceeded)
        self.n_launch_faults = 0     # launches that raised
        # transient faults recovered by a retry (the reference's name: its
        # retry runs the ref path, the port's the same launch again)
        self.n_ref_retries = 0
        self.n_failed = 0            # requests resolved with LaunchFault
        self.worker_restarts = 0     # supervisor restarts of the serve loop
        self.n_batches = 0
        self.n_points = 0
        self.n_padded_rows = 0

    def record_batch(self, reqs: list, bucket: int) -> None:
        with self.lock:
            self.n_batches += 1
            rows = sum(r.points.shape[0] for r in reqs)
            self.n_points += rows
            self.n_padded_rows += bucket - rows

    def record_latency(self, ms: float) -> None:
        with self.lock:
            self.latencies_ms.append(ms)

    def bump(self, counter: str, by: int = 1) -> None:
        with self.lock:
            setattr(self, counter, getattr(self, counter) + by)

    def to_dict(self) -> dict:
        with self.lock:
            lat = np.asarray(self.latencies_ms, dtype=np.float64)
            out = {
                "n_requests": self.n_requests,
                "n_rejected": self.n_rejected,
                "n_quota_rejected": self.n_quota_rejected,
                "n_breaker_rejected": self.n_breaker_rejected,
                "n_invalid": self.n_invalid,
                "n_cancelled": self.n_cancelled,
                "n_deadline_shed": self.n_deadline_shed,
                "n_launch_faults": self.n_launch_faults,
                "n_ref_retries": self.n_ref_retries,
                "n_failed": self.n_failed,
                "worker_restarts": self.worker_restarts,
                "n_batches": self.n_batches,
                "n_points": self.n_points,
                "n_padded_rows": self.n_padded_rows,
                "requests_per_batch": (
                    self.n_requests / self.n_batches if self.n_batches else 0.0),
            }
        if lat.size:
            out["p50_ms"] = float(np.percentile(lat, 50))
            out["p99_ms"] = float(np.percentile(lat, 99))
            out["mean_ms"] = float(lat.mean())
        return out


class Batcher:
    """One model's bounded queue + supervised coalescing worker thread."""

    def __init__(self, entry: ModelEntry, config: ServeConfig,
                 trace=None):
        self._entry = entry
        self._cfg = config
        self._buckets = config.buckets()
        self._queue: collections.deque[_Request] = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._tenant_pending: collections.Counter = collections.Counter()
        self._inflight: list[_Request] = []
        self._bucket_fail_streak: collections.Counter = collections.Counter()
        self.stats = BatcherStats()
        self._trace_cb = trace
        self.events: list = []
        self.breaker = CircuitBreaker(
            entry.model_id,
            threshold=config.breaker_threshold,
            backoff_s=config.breaker_backoff_s,
            backoff_max_s=config.breaker_backoff_max_s,
            seed=config.seed,
            on_event=self._emit)
        self._worker = threading.Thread(
            target=self._supervise, name=f"serve-{entry.model_id}",
            daemon=True)
        self._worker.start()

    def _emit(self, event: tuple) -> None:
        self.events.append(event)
        if self._trace_cb is not None:
            self._trace_cb(event)

    # -- client side --------------------------------------------------------
    def submit(self, points, *, deadline_ms: float | None = None,
               tenant: str = "default", validate: bool | None = None
               ) -> Future:
        """Enqueue one request; returns a Future[AssignResponse].

        Admission is checked immediately, never by blocking the caller:
        :class:`ServerClosed` after shutdown, :class:`ModelUnhealthy`
        while the circuit breaker is open, :class:`QueueFull` /
        :class:`QuotaExceeded` on a saturated queue or tenant quota, and
        :class:`InvalidRequest` for non-finite payloads (unless
        ``validate=False`` — a trusted-client fast path).
        ``deadline_ms`` overrides ``config.default_deadline_ms``; an
        expired request is shed from the queue with
        :class:`DeadlineExceeded` instead of wasting a launch slot.
        """
        pts = devices.host_array(points, np.float32)
        if pts.ndim == 1:
            pts = pts[None, :]
        n = self._entry.snapshot().n_features
        if pts.ndim != 2 or pts.shape[1] != n:
            raise ValueError(
                f"request points must be [m, {n}], got {pts.shape}")
        if pts.shape[0] == 0:
            raise ValueError("empty request")
        if pts.shape[0] > self._cfg.max_batch:
            raise ValueError(
                f"request of {pts.shape[0]} points exceeds "
                f"max_batch={self._cfg.max_batch}; split it client-side")
        if deadline_ms is None:
            deadline_ms = self._cfg.default_deadline_ms
        elif deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be positive, got {deadline_ms!r}")
        if (self._cfg.validate_requests if validate is None else validate) \
                and not np.isfinite(pts).all():
            self.stats.bump("n_invalid")
            raise InvalidRequest(
                f"request for model {self._entry.model_id!r} contains "
                "non-finite values (NaN/Inf); rejected at admission so it "
                "cannot poison a coalesced launch")
        if not self.breaker.allow():
            self.stats.bump("n_breaker_rejected")
            retry_in = self.breaker.retry_in_s()
            raise ModelUnhealthy(
                f"model {self._entry.model_id!r} circuit breaker is "
                f"{self.breaker.state}; retry in {retry_in:.2f}s",
                retry_in_s=retry_in)
        req = _Request(
            pts,
            deadline=(time.monotonic() + deadline_ms / 1e3
                      if deadline_ms is not None else None),
            tenant=tenant)
        with self._cond:
            if self._closed:
                raise ServerClosed(
                    f"model {self._entry.model_id!r} is not serving")
            if len(self._queue) >= self._cfg.queue_depth:
                self.stats.bump("n_rejected")
                raise QueueFull(
                    f"model {self._entry.model_id!r}: {len(self._queue)} "
                    f"requests pending (queue_depth="
                    f"{self._cfg.queue_depth}); retry with backoff")
            quota = self._cfg.tenant_quota
            if quota is not None and self._tenant_pending[tenant] >= quota:
                self.stats.bump("n_quota_rejected")
                raise QuotaExceeded(
                    f"model {self._entry.model_id!r}: tenant {tenant!r} has "
                    f"{self._tenant_pending[tenant]} requests pending "
                    f"(tenant_quota={quota}); retry with backoff")
            self._queue.append(req)
            self._tenant_pending[tenant] += 1
            self.stats.bump("n_requests")
            self._cond.notify()
        return req.future

    def cancel(self, future: Future) -> bool:
        """Withdraw a queued request (``assign`` timeout path).

        Removes it from the queue so no launch slot is burned on a client
        that already gave up, and cancels the future so the worker skips
        it even if it was dequeued concurrently.  Returns True if the
        future will never be launched; a request already in a launch
        cannot be recalled (its result is simply dropped by the caller).
        """
        with self._cond:
            for i, r in enumerate(self._queue):
                if r.future is future:
                    del self._queue[i]
                    self._tenant_pending[r.tenant] -= 1
                    future.cancel()
                    self.stats.bump("n_cancelled")
                    return True
        # Not queued: either about to launch (cancel() wins the race only
        # if the worker has not marked it running yet) or already done.
        won = future.cancel()
        if won:
            self.stats.bump("n_cancelled")
        return won

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def worker_alive(self) -> bool:
        return self._worker.is_alive()

    # -- worker side --------------------------------------------------------
    def _admit(self, req: _Request) -> bool:
        """Post-dequeue admission: skip cancelled, shed expired."""
        if not req.future.set_running_or_notify_cancel():
            return False                         # client cancelled in queue
        if req.deadline is not None:
            overdue = time.monotonic() - req.deadline
            if overdue > 0:
                self.stats.bump("n_deadline_shed")
                self._emit(("deadline_shed", self._entry.model_id,
                            round(overdue * 1e3, 3)))
                req.future.set_exception(DeadlineExceeded(
                    f"model {self._entry.model_id!r}: deadline exceeded by "
                    f"{overdue * 1e3:.1f}ms while queued; request shed "
                    "before launch"))
                return False
        return True

    def _dequeue_locked(self) -> _Request:
        req = self._queue.popleft()
        self._tenant_pending[req.tenant] -= 1
        self._inflight.append(req)
        return req

    def _take_batch(self) -> list[_Request] | None:
        """Block for the first admitted request, then linger to coalesce.

        Cancelled and deadline-expired requests are resolved and skipped
        here — before any launch capacity is reserved for them.  Returns
        None only when closed and drained.
        """
        first = None
        while first is None:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return None                  # closed and drained
                req = self._dequeue_locked()
            if self._admit(req):
                first = req
        batch = [first]
        total = first.points.shape[0]
        deadline = first.t_submit + self._cfg.max_linger_ms / 1e3
        while total < self._cfg.max_batch:
            with self._cond:
                if self._queue:
                    m = self._queue[0].points.shape[0]
                    if total + m > self._cfg.max_batch:
                        break                    # next request rides later
                    req = self._dequeue_locked()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(remaining)
                    continue
            if self._admit(req):
                batch.append(req)
                total += req.points.shape[0]
        return batch

    def _bucket_for(self, rows: int) -> int:
        b = max(_next_pow2(rows), self._buckets[0])
        return min(b, self._buckets[-1])

    def _pack(self, batch: list[_Request]) -> tuple[torch.Tensor, int]:
        """The batch's rows in the bucket's host buffer, zero-padded (the
        padding rows are part of the launch: under int8 they enter the
        per-feature scales as zeros, as in the reference)."""
        rows = sum(r.points.shape[0] for r in batch)
        bucket = self._bucket_for(rows)
        buf = self._entry.host_buffer(bucket)
        view = buf.numpy()
        off = 0
        for r in batch:
            m = r.points.shape[0]
            view[off:off + m] = r.points
            off += m
        view[off:] = 0.0
        return buf, bucket

    def _scatter(self, batch, ids, dists, snap, bucket) -> None:
        t_done = time.monotonic()
        self.stats.record_batch(batch, bucket)
        off = 0
        for r in batch:
            m = r.points.shape[0]
            latency_ms = (t_done - r.t_submit) * 1e3
            self.stats.record_latency(latency_ms)
            r.future.set_result(AssignResponse(
                ids=ids[off:off + m].copy(),
                dists=dists[off:off + m].copy(),
                model_id=self._entry.model_id,
                version=snap.version,
                step=snap.step,
                latency_ms=latency_ms,
                batch_rows=bucket,
                n_coalesced=len(batch)))
            off += m

    # -- fault-isolated launch ----------------------------------------------
    def _launch_batch(self, batch: list[_Request]) -> None:
        """Launch ``batch``; classify, retry, bisect on failure.

        Transient faults retry the whole batch by relaunching it
        (``launch_retries`` attempts; the kernel again, not the plain
        version).  Permanent faults — and
        transients whose retries failed — bisect: each half re-launches at
        its own bucket, so a single poisoned request fails alone with
        :class:`LaunchFault` while its coalesced neighbors are served
        (bitwise-identically to a healthy launch, by the same padding
        invariance the buckets already rely on: each row's result on the
        card comes from that row alone, except under int8, whose
        per-feature scales are taken over the whole padded launch).  Every successful
        (sub-)launch feeds the circuit breaker a success, every
        single-request dead end a failure — only a model failing
        *everything* accumulates to the trip threshold.
        """
        snap = self._entry.snapshot()            # ONE snapshot per launch
        buf, bucket = self._pack(batch)
        demoted = self._entry.is_demoted(bucket)
        if demoted and self._entry.device.type != "cpu":
            # No plain route on the card: a demoted bucket's requests fail.
            self._fail(batch, "[demoted]", RuntimeError(
                f"bucket {bucket} demoted after repeated launch faults"))
            return
        try:
            if demoted:
                # Route around the failing primary at the batcher level,
                # so a wrapped/instrumented primary launch is not touched.
                ids, dists = self._entry.launch_fallback(buf, snap)
            else:
                ids, dists = self._entry.launch(buf, snap)
        except Exception as exc:
            self._on_launch_fault(batch, buf, snap, bucket, exc)
            return
        self._bucket_fail_streak[bucket] = 0
        self.breaker.record_success()
        self._scatter(batch, ids, dists, snap, bucket)

    def _on_launch_fault(self, batch, buf, snap, bucket, exc) -> None:
        kind = faults.classify(exc)
        self.stats.bump("n_launch_faults")
        self._emit(("launch_fault", self._entry.model_id,
                    f"{kind}: {type(exc).__name__}: {exc}"))
        streak = self._bucket_fail_streak[bucket] + 1
        self._bucket_fail_streak[bucket] = streak
        if self._cfg.demote_after and streak == self._cfg.demote_after:
            # This bucket keeps failing on the primary path: take it off
            # its kernel for the entry's lifetime.
            self._entry.demote_bucket(bucket, exc)
        if kind == faults.TRANSIENT:
            # The payload is not implicated: launch it again, from the
            # host buffer (untouched by the failed launch).
            for _ in range(self._cfg.launch_retries):
                try:
                    ids, dists = self._entry.relaunch(buf, snap)
                except Exception as exc2:  # noqa: BLE001 — classified below
                    exc = exc2
                    self._emit(("launch_fault", self._entry.model_id,
                                f"retry: {type(exc).__name__}: {exc}"))
                    continue
                self.stats.bump("n_ref_retries")
                self.breaker.record_success()
                self._scatter(batch, ids, dists, snap, bucket)
                return
        if len(batch) == 1:
            # Fully isolated: this request is implicated; fail it alone.
            self._fail(batch, f"[{kind}] after isolation", exc)
            return
        # Permanent fault in a coalesced launch: bisect so only the
        # requests actually causing it fail.  Each half re-buckets and
        # re-launches; healthy halves return bitwise-identical results.
        mid = len(batch) // 2
        for half in (batch[:mid], batch[mid:]):
            self._launch_batch(half)

    def _fail(self, batch: list[_Request], why: str, exc: Exception) -> None:
        """Resolve every request of ``batch`` with :class:`LaunchFault` and
        feed the breaker one failure."""
        self.breaker.record_failure(f"{type(exc).__name__}: {exc}")
        self.stats.bump("n_failed", len(batch))
        for req in batch:
            req.future.set_exception(LaunchFault(
                f"model {self._entry.model_id!r}: launch failed {why}: "
                f"{type(exc).__name__}: {exc}"))

    # -- supervised serve loop ----------------------------------------------
    def _serve_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return                           # clean shutdown
            if not batch:
                continue                         # everything shed/cancelled
            self._launch_batch(batch)
            self._inflight.clear()

    def _fail_request(self, req: _Request, exc: Exception) -> None:
        try:
            req.future.set_exception(exc)
        except Exception:  # noqa: BLE001 — already resolved/cancelled
            pass

    def _on_worker_crash(self, exc: BaseException) -> None:
        """Fail everything pending, loudly, then let the loop restart."""
        err = WorkerCrashed(
            f"serving worker for model {self._entry.model_id!r} crashed "
            f"({type(exc).__name__}: {exc}); pending requests failed and "
            "the worker restarted")
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._tenant_pending.clear()
            inflight = list(self._inflight)
            self._inflight.clear()
        for r in inflight + pending:
            self._fail_request(r, err)
        self.stats.bump("worker_restarts")
        self._emit(("worker_restart", self._entry.model_id,
                    f"{type(exc).__name__}: {exc}"))

    def _supervise(self) -> None:
        """The worker thread: run the serve loop, restart it on crashes.

        ``_serve_loop`` returning means closed-and-drained; anything
        *raising* out of it is a worker crash — without supervision that
        thread death would strand every queued future while ``submit``
        kept accepting."""
        while True:
            try:
                self._serve_loop()
                return
            except BaseException as exc:  # noqa: BLE001 — supervisor
                self._on_worker_crash(exc)
                with self._cond:
                    if self._closed:
                        return

    def close(self, drain: bool = True) -> None:
        """Stop accepting requests; finish (or fail) what is queued."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = [] if drain else list(self._queue)
            if not drain:
                self._queue.clear()
                self._tenant_pending.clear()
            self._cond.notify_all()
        for r in pending:
            self._fail_request(r, ServerClosed(
                f"model {self._entry.model_id!r} shut down"))
        self._worker.join(timeout=10.0)
