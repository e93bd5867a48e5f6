"""`repro_torch.serve` — the batching assignment-serving subsystem.

The port of the reference's ``repro.serve``.  The paper's end product is a
centroid set whose value is realized at assignment time; point-to-centroid
lookup is itself a streaming big-data workload.  This package serves it on
the card:

* :class:`Batcher` — coalesces concurrent client requests into one assign
  launch: power-of-two padded shape buckets, each replayed from one CUDA
  graph captured at warmup (zero captures after it), a bounded queue with
  a max-linger deadline, per-request latency accounting.
* :class:`ModelRegistry` — multi-model tenancy: several (k, n) centroid
  sets resident at once, each with its own precision/impl policy routed
  through the autotuned ``kernels/ops.assign`` dispatch (kernels B, B8,
  B16, B3).
* :mod:`repro_torch.serve.swap` — hot-swap: atomically replace a model's
  serving centroids (directly, or from the newest intact SHA-256-verified
  checkpoint) without dropping or re-queuing in-flight requests;
  :class:`CheckpointWatcher` automates it.
* :mod:`repro_torch.serve.resilience` — the serving fault discipline:
  typed request failures (never a hang), per-model circuit breakers with
  seeded half-open probes, deadline shedding, per-tenant quotas,
  fault-isolated (classify → retry → bisect) launches, and a
  supervised worker that fails pending futures and restarts on crashes.
* :class:`Server` / :func:`serve` — the assembled service, also exported
  from ``repro_torch.api``; ``Server.health()`` aggregates breaker states,
  queue depths, worker/watcher liveness and swap ages.

Departures from the reference, stated: a kernel that fails at warmup
raises (the reference demotes it; the port keeps no demotion table); a
transient launch fault retries the same launch (on the card the bucket's
graph replayed), not the ref path; a demoted bucket is this model's only,
and on the card, where there is no plain route, its requests fail with
:class:`LaunchFault`; ``ServeConfig.donate`` changes nothing.  ``chip_smoke.py`` phase 10 drives it on the card.
"""
from repro_torch.serve.batcher import AssignResponse, Batcher, BatcherStats
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.registry import (
    CentroidSnapshot, ModelEntry, ModelRegistry,
)
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
from repro_torch.serve.server import Server, serve
from repro_torch.serve.swap import (
    CheckpointWatcher,
    load_centroids,
    swap_from_checkpoint,
)

__all__ = [
    "AssignResponse",
    "Batcher",
    "BatcherStats",
    "CentroidSnapshot",
    "CheckpointWatcher",
    "CircuitBreaker",
    "DeadlineExceeded",
    "InvalidRequest",
    "LaunchFault",
    "ModelEntry",
    "ModelRegistry",
    "ModelUnhealthy",
    "QueueFull",
    "QuotaExceeded",
    "ServeConfig",
    "Server",
    "ServerClosed",
    "WorkerCrashed",
    "load_centroids",
    "serve",
    "swap_from_checkpoint",
]
