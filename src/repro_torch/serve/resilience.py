"""Serving-side resilience vocabulary: typed faults + the circuit breaker.

The port of the reference's ``repro.serve.resilience`` (it holds no JAX,
but the port keeps its own copy).  The serving layer speaks the same fault
discipline as the streaming engine (:mod:`repro_torch.engine.faults`):
every way a request can fail resolves its future with a *typed* exception
— never a hang — and the per-model circuit breaker turns a dying model
into fast, cheap rejections instead of a queue of doomed launches.

Exceptions (all reachable from ``repro_torch.serve``):

* :class:`DeadlineExceeded` — the request's deadline expired while it sat
  in the queue (shed before wasting a launch slot) or before submission.
* :class:`InvalidRequest` — the payload failed admission validation
  (non-finite values); a ``ValueError`` subclass, i.e. a *client* error.
* :class:`LaunchFault` — the launch carrying this request failed
  permanently (after transient retries and batch bisection isolated it).
* :class:`ModelUnhealthy` — the model's circuit breaker is open; retry
  after ``retry_in_s``.
* :class:`QuotaExceeded` — the per-tenant admission quota is full
  (a :class:`QueueFull` subclass: same backpressure contract).
* :class:`WorkerCrashed` — the batcher worker died with this request
  pending; the supervisor failed it and restarted the worker.

The breaker follows the classic three-state machine, with the same
seeded-determinism rule as the engine's :class:`RetryPolicy`: the open →
half-open backoff is jittered by a PRNG seeded from ``(seed, trips)``, so
a replayed chaos run probes at identical offsets.
"""
from __future__ import annotations

import threading
import time

import numpy as np

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class QueueFull(RuntimeError):
    """The model's request queue is at ``queue_depth``; retry later."""


class ServerClosed(RuntimeError):
    """The server (or this model's batcher) has been shut down."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before a launch could serve it."""


class InvalidRequest(ValueError):
    """The request payload failed admission validation (non-finite values):
    a client error, rejected at submit time so it can never poison a
    coalesced launch."""


class LaunchFault(RuntimeError):
    """The launch carrying this request failed permanently.  Bisection has
    already isolated the failure: coalesced neighbors were re-launched and
    served; only the requests actually implicated carry this exception."""


class ModelUnhealthy(RuntimeError):
    """The model's circuit breaker is open: recent launches failed
    consecutively, so requests fast-fail instead of queueing for a doomed
    launch.  ``retry_in_s`` says when the next half-open probe is due."""

    def __init__(self, msg: str, retry_in_s: float = 0.0):
        super().__init__(msg)
        self.retry_in_s = retry_in_s


class QuotaExceeded(QueueFull):
    """This tenant's admission quota is full (other tenants still admit):
    per-tenant backpressure, same retry contract as :class:`QueueFull`."""


class WorkerCrashed(RuntimeError):
    """The batcher worker thread crashed while this request was pending.
    The supervisor failed every pending future with this exception and
    restarted the worker — clients see an error, never a hang."""


class CircuitBreaker:
    """Per-model three-state circuit breaker with seeded probe backoff.

    * **closed** — healthy; every launch outcome is recorded, and
      ``threshold`` *consecutive* failed launches trip the breaker.  A
      bisected batch records per-sub-launch, so one poisoned request among
      healthy traffic (fail, success, …) never accumulates to the
      threshold — only a model failing *everything* does.
    * **open** — submits fast-fail with :class:`ModelUnhealthy` until the
      backoff expires: ``min(backoff_s · 2^(trips−1), backoff_max_s)``
      jittered by a PRNG seeded from ``(seed, trips)`` (deterministic
      replay, no thundering probes).
    * **half_open** — the first ``allow()`` after the backoff admits one
      probe request; everyone else keeps fast-failing.  The probe's launch
      outcome closes the breaker (success) or re-opens it with a doubled
      backoff (failure).

    ``threshold=0`` disables the breaker (``allow()`` is always True and
    nothing ever trips).  ``on_event`` receives ``("breaker_open", ...)``
    / ``("breaker_probe", ...)`` / ``("breaker_close", ...)`` trace tuples.
    """

    def __init__(self, model_id: str, *, threshold: int = 5,
                 backoff_s: float = 1.0, backoff_max_s: float = 30.0,
                 seed: int = 0, clock=time.monotonic, on_event=None):
        self.model_id = model_id
        self.threshold = threshold
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.seed = seed
        self._clock = clock
        self._on_event = on_event or (lambda event: None)
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0          # consecutive failed launches
        self.trips = 0             # times the breaker has opened
        self._retry_at = 0.0

    # -- policy --------------------------------------------------------------
    def _probe_delay(self) -> float:
        base = min(self.backoff_s * (2.0 ** max(self.trips - 1, 0)),
                   self.backoff_max_s)
        rng = np.random.default_rng((self.seed, 0xB4EA, self.trips))
        return base * (0.5 + 0.5 * float(rng.random()))

    def allow(self) -> bool:
        """May a new request be admitted right now?  (Transitions open →
        half_open when the probe backoff has expired.)"""
        if self.threshold <= 0:
            return True
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN and self._clock() >= self._retry_at:
                self.state = HALF_OPEN
                self._on_event(("breaker_probe", self.model_id, self.trips))
                return True                       # this caller is the probe
            return False                          # open, or probe in flight

    def retry_in_s(self) -> float:
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(self._retry_at - self._clock(), 0.0)

    # -- launch outcomes -----------------------------------------------------
    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            was = self.state
            self.state = CLOSED
            self.failures = 0
        if was != CLOSED:
            self._on_event(("breaker_close", self.model_id, self.trips))

    def record_failure(self, reason: str = "") -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self.failures += 1
            trip = (self.state == HALF_OPEN
                    or (self.state == CLOSED
                        and self.failures >= self.threshold))
            if not trip:
                return
            self.state = OPEN
            self.trips += 1
            self._retry_at = self._clock() + self._probe_delay()
        self._on_event(("breaker_open", self.model_id,
                        reason or f"{self.failures} consecutive failures"))

    # -- telemetry -----------------------------------------------------------
    def describe(self) -> dict:
        """A JSON-safe snapshot for ``Server.health()`` (no transitions)."""
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.failures,
                "trips": self.trips,
                "retry_in_s": (round(max(self._retry_at - self._clock(), 0.0),
                                     3) if self.state == OPEN else 0.0),
            }
