"""`ServeConfig` — every knob of the assignment-serving subsystem.

Serving has a different shape from training: many small concurrent
requests instead of a few huge chunks, so the knobs are about *coalescing*
(how long to wait, how much to pack into one launch) and *admission* (how
deep the queue may grow before clients are told to back off) rather than
chunk budgets.  One config drives every model the server hosts; precision
and kernel impl can still be overridden per model at registration time.

The port of the reference's ``repro.serve.config``: the same fields,
defaults, validation and messages; ``impl`` is checked against the port's
``ops.IMPLS`` (``'cuda'``, ``'ref'``, ``'ref_chunked'``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import ops
from repro_torch.kernels import precision as px

_DONATE_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Validated configuration for one :class:`repro_torch.serve.Server`.

    Batching frontend:

    * ``max_batch`` — most points one coalesced launch may carry; also the
      largest padded shape bucket.  Rounded up to a power of two.
    * ``min_bucket`` — smallest padded launch shape.  Requests are padded to
      the next power-of-two bucket in ``[min_bucket, max_batch]`` so the
      assign launch sees a small, fixed set of shapes: on the card one
      CUDA graph per bucket, captured once, never per request size.
    * ``max_linger_ms`` — how long the batcher may hold the first request of
      a batch waiting for more to coalesce (the latency/throughput knob:
      0 launches immediately, a few ms packs concurrent clients together).
    * ``queue_depth`` — max requests pending per model; beyond it
      :meth:`Server.submit` raises :class:`QueueFull`
      immediately (graceful rejection, never a hang).

    Kernel dispatch (defaults for every model; overridable per model):

    * ``impl`` — kernel implementation (``'auto'`` resolves via
      :func:`repro_torch.kernels.ops.resolve_impl`: the CUDA kernels on
      the card, the plain PyTorch oracles on the CPU).
    * ``precision`` — per-model precision policy routed through
      ``kernels/ops.assign`` (see :mod:`repro_torch.kernels.precision`).
    * ``donate`` — accepted and validated as in the reference (donate the
      padded request buffer to the jitted call; ``'auto'`` = on for the
      card, off on the CPU), and changes nothing: on the card every bucket
      stages its rows into the static input buffer of its CUDA graph
      whatever ``donate`` says, so ``'on'``, ``'off'`` and ``'auto'`` give
      identical results.
    * ``warmup`` — at registration, eagerly run every shape bucket through
      the autotune-consulting dispatch (:func:`ops.warm_assign`) and build
      its launch plan (on the card: capture its CUDA graph), so tuning and
      capture happen off the request path (zero captures once traffic
      starts).  A kernel that fails to build or launch there raises: the
      port keeps no demotion table.

    Admission & resilience (see :mod:`repro_torch.serve.resilience`):

    * ``default_deadline_ms`` — per-request deadline applied when a submit
      does not pass its own; ``None`` = requests never expire.  A request
      whose deadline lapses while queued is *shed* with
      :class:`DeadlineExceeded` before it can waste a launch slot.
    * ``validate_requests`` — reject non-finite payloads at submit time
      with :class:`InvalidRequest` (a client error) instead of
      letting a NaN poison a coalesced launch.  Per-submit ``validate=``
      overrides it for trusted clients.
    * ``tenant_quota`` — max *queued* requests per tenant id; beyond it
      :class:`QuotaExceeded` (one noisy tenant can no longer
      occupy the whole queue).  ``None`` = no per-tenant bound.
    * ``launch_retries`` — how many times a launch that failed with a
      *transient* fault is launched again (``ModelEntry.relaunch``: on
      the card the bucket's graph replayed; the reference retries on its
      ref path) before the batch is bisected.
    * ``demote_after`` — consecutive primary-launch failures at one shape
      bucket before that bucket of this model leaves its kernel for the
      model's lifetime (``ModelEntry.demote_bucket``; the port keeps no
      process-wide demotion table): on the CPU it runs the ref path, on
      the card its requests fail with :class:`LaunchFault`; 0 never
      demotes.
    * ``breaker_threshold`` — consecutive failed launches that trip the
      per-model circuit breaker (fast-fail
      :class:`ModelUnhealthy` until a half-open probe
      succeeds); 0 disables the breaker.
    * ``breaker_backoff_s`` / ``breaker_backoff_max_s`` — open → half-open
      probe backoff: doubles per consecutive trip, jittered by a PRNG
      seeded from ``(seed, trips)`` (deterministic replay).
    * ``seed`` — seeds the breaker's probe jitter.

    Hot-swap:

    * ``poll_interval_s`` — how often a :class:`CheckpointWatcher`
      polls its checkpoint directory for a newer intact step.
    * ``watcher_timeout_s`` — watchdog bound on one watcher poll (a hung
      checkpoint load is abandoned and counted as a stalled poll instead
      of freezing hot-swap forever); ``None`` = no watchdog.
    """

    max_batch: int = 4096
    min_bucket: int = 64
    max_linger_ms: float = 2.0
    queue_depth: int = 256
    impl: str = "auto"
    precision: str = "auto"
    donate: str = "auto"
    warmup: bool = True
    poll_interval_s: float = 0.2
    default_deadline_ms: float | None = None
    validate_requests: bool = True
    tenant_quota: int | None = None
    launch_retries: int = 1
    demote_after: int = 3
    breaker_threshold: int = 5
    breaker_backoff_s: float = 1.0
    breaker_backoff_max_s: float = 30.0
    seed: int = 0
    watcher_timeout_s: float | None = 30.0

    def __post_init__(self):
        def _positive(name, value):
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 1:
                raise ValueError(
                    f"{name} must be a positive int, got {value!r}")

        _positive("max_batch", self.max_batch)
        _positive("min_bucket", self.min_bucket)
        _positive("queue_depth", self.queue_depth)
        if self.min_bucket > self.max_batch:
            raise ValueError(
                f"min_bucket={self.min_bucket} must be <= "
                f"max_batch={self.max_batch}")
        if self.max_linger_ms < 0:
            raise ValueError(
                f"max_linger_ms must be >= 0, got {self.max_linger_ms!r}")
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be positive, "
                f"got {self.poll_interval_s!r}")
        if self.default_deadline_ms is not None \
                and self.default_deadline_ms <= 0:
            raise ValueError(
                f"default_deadline_ms must be positive or None, "
                f"got {self.default_deadline_ms!r}")
        if not isinstance(self.validate_requests, bool):
            raise ValueError(
                f"validate_requests must be a bool, "
                f"got {self.validate_requests!r}")
        if self.tenant_quota is not None:
            _positive("tenant_quota", self.tenant_quota)
        for name in ("launch_retries", "demote_after", "breaker_threshold"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 0:
                raise ValueError(
                    f"{name} must be a non-negative int, got {value!r}")
        if self.breaker_backoff_s <= 0 or self.breaker_backoff_max_s <= 0:
            raise ValueError("breaker backoffs must be positive")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        if self.watcher_timeout_s is not None and self.watcher_timeout_s <= 0:
            raise ValueError(
                f"watcher_timeout_s must be positive or None, "
                f"got {self.watcher_timeout_s!r}")
        if self.impl != "auto" and self.impl not in ops.IMPLS:
            raise ValueError(
                f"unknown impl {self.impl!r}; known: ('auto',) + {ops.IMPLS}")
        if self.precision != "auto":
            px.check(self.precision)
        if self.donate not in _DONATE_MODES:
            raise ValueError(
                f"donate must be one of {_DONATE_MODES}, got {self.donate!r}")
        if not isinstance(self.warmup, bool):
            raise ValueError(f"warmup must be a bool, got {self.warmup!r}")

    def replace(self, **overrides) -> "ServeConfig":
        """A copy with ``overrides`` applied (re-validated)."""
        return dataclasses.replace(self, **overrides)

    def buckets(self) -> tuple[int, ...]:
        """The padded power-of-two launch shapes, ascending.

        Every coalesced batch is padded up to the smallest bucket that
        holds it, so each model holds exactly ``len(buckets())`` launch
        plans (CUDA graphs on the card) and a new request size never
        triggers a capture after warmup.
        """
        lo = _next_pow2(self.min_bucket)
        hi = _next_pow2(self.max_batch)
        out = []
        b = lo
        while b < hi:
            out.append(b)
            b *= 2
        out.append(hi)
        return tuple(out)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p
