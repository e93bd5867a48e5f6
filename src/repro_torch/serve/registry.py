"""Multi-model tenancy: several centroid sets resident and servable at once.

The port of the reference's ``repro.serve.registry``.  A
:class:`ModelRegistry` maps model ids to :class:`ModelEntry` objects.
Each entry owns

* an immutable :class:`CentroidSnapshot` behind an atomic pointer — the
  unit of hot-swap.  A batch launch reads the pointer exactly once, so a
  swap lands between launches and old/new centroids are never mixed within
  one response;
* its own kernel policy (``impl`` resolved once at registration,
  ``precision`` routed through ``kernels/ops.assign``);
* one launch plan per padded shape bucket.  On the card a plan is a CUDA
  graph of the policy's assign launch (kernel B, B8, B16 or B3, with the
  int8 chunk and centroid quantization captured beside B8) over three
  static parts: an input buffer ``[bucket, n]``, a centroid buffer
  ``[k, n]`` that the entry owns (one for all its buckets) and the outputs.
  On the CPU the plan is the plain call.  ``recompiles`` counts the plans
  built — on the card, the captures — so after bucket warmup it equals
  ``len(buckets)`` and never grows: the port's form of the reference's
  zero-recompile contract.

A swap builds and validates a new device snapshot and never captures.
Only the batcher's worker launches: when the snapshot it read is not the
one it staged last, it copies that snapshot's centroids into the static
centroid buffer on the entry's stream before the replay, so every response
comes from exactly one generation and a swap costs one device copy.

Swaps append a ``("swap", model_id, step)`` event to the registry trace,
the serving twin of the engine's trace-event vocabulary.
"""
from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.kernels import build, ops
from repro_torch.kernels import precision as px


@dataclass(frozen=True)
class CentroidSnapshot:
    """One immutable, device-resident centroid set.

    ``version`` increments on every swap; ``step`` is the checkpoint step
    the snapshot came from (None for directly registered arrays).  Every
    :class:`repro_torch.serve.AssignResponse` records the (version, step)
    that served it, so clients and tests can attribute results to exactly
    one centroid generation.  ``t_swapped`` (monotonic seconds) is when
    this generation went live — ``Server.health()`` reports its age.
    """

    centroids: torch.Tensor     # [k, n] f32 on the entry's device
    version: int
    step: int | None
    t_swapped: float = field(default_factory=time.monotonic, compare=False)

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_features(self) -> int:
        return self.centroids.shape[1]


def _as_centroids(obj, device: torch.device) -> torch.Tensor:
    """A copy, as f32 on ``device``, of a raw [k, n] array or tensor or of
    anything with a ``.centroids`` field (e.g. a
    :class:`repro_torch.api.FitResult`).  Raises ``ValueError`` on another
    rank or on non-finite values (the check reads the card, so the copy
    has landed when this returns)."""
    arr = getattr(obj, "centroids", obj)
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.asarray(arr, dtype=np.float32))
    arr = arr.to(device=device, dtype=torch.float32, copy=True).contiguous()
    if arr.ndim != 2:
        raise ValueError(
            f"centroids must be [k, n], got shape {tuple(arr.shape)}")
    if not bool(torch.isfinite(arr).all()):
        raise ValueError("centroids contain non-finite values")
    return arr


_build_lock = threading.Lock()


class _GraphPlan:
    """One bucket's assign launch on the card, captured as a CUDA graph.

    The static input ``x`` and the entry's centroid buffer are the graph's
    inputs, ``ids`` / ``d`` its outputs.  ``host_ids`` / ``host_d`` are
    pinned, so the read-back after a replay is one asynchronous copy each
    and one synchronisation of the entry's stream.

    ``launches`` is what the kernel wrappers counted during the capture
    on the capturing thread ({counter: launches}, their ``build.tally``;
    a fit launching on another thread meanwhile adds nothing to it).  A
    capture launches nothing, so that count is taken back, and each replay
    adds it again: the counters then show what the replays launched.
    """

    def __init__(self, entry: "ModelEntry", bucket: int):
        n, dev = entry.n_features, entry.device
        self.x = torch.zeros((bucket, n), dtype=torch.float32, device=dev)
        self.host_ids = torch.empty(bucket, dtype=torch.int32,
                                    pin_memory=True)
        self.host_d = torch.empty(bucket, dtype=torch.float32,
                                  pin_memory=True)
        self.graph = torch.cuda.CUDAGraph()
        # A graph that the cyclic collector frees inside this capture (a
        # closed server's plan, say) invalidates it: no collection during
        # a capture.  Holding the counters' lock keeps other entries'
        # replays from adding to them, and a reset from clearing them,
        # until the capture's count is taken back.
        with ops.counts_held():
            collecting = gc.isenabled()
            gc.disable()
            try:
                with build.tally() as launched, torch.cuda.graph(
                        self.graph, stream=entry.stream,
                        capture_error_mode="thread_local"):
                    self.ids, self.d = ops.assign(
                        self.x, entry.centroid_buffer, impl=entry.impl,
                        precision=entry.precision)
            finally:
                if collecting:
                    gc.enable()
            self.launches = dict(launched)
            ops.add_launch_counts(
                {name: -v for name, v in self.launches.items()})

    def __call__(self, q: torch.Tensor, stream) -> tuple[np.ndarray,
                                                         np.ndarray]:
        with torch.cuda.stream(stream):
            self.x.copy_(q, non_blocking=True)
            self.graph.replay()
            self.host_ids.copy_(self.ids, non_blocking=True)
            self.host_d.copy_(self.d, non_blocking=True)
        stream.synchronize()
        ops.add_launch_counts(self.launches)
        return self.host_ids.numpy().copy(), self.host_d.numpy().copy()


class ModelEntry:
    """One resident model: a swappable snapshot + its per-bucket launch
    plans, on ``device`` (None: the card)."""

    def __init__(self, model_id: str, centroids, *, impl: str = "auto",
                 precision: str = "auto", device=None):
        self.device = devices.resolve(device)
        arr = _as_centroids(centroids, self.device)
        self.model_id = model_id
        self.impl = ops.resolve_impl(impl, self.device)
        self.precision = px.resolve(precision, arr.dtype)
        self._lock = threading.Lock()
        self._snapshot = CentroidSnapshot(arr, version=0, step=None)
        self._recompiles = 0
        self._plans: dict[int, _GraphPlan | None] = {}
        self._host: dict[int, torch.Tensor] = {}
        self._demoted_buckets: set[int] = set()
        self.replays: dict[int, int] = {}        # launches per bucket
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.centroid_buffer = arr.clone()
            self._staged = self._snapshot

    @property
    def n_features(self) -> int:
        return self._snapshot.n_features

    # -- kernel dispatch ----------------------------------------------------
    def host_buffer(self, bucket: int) -> torch.Tensor:
        """The ``[bucket, n]`` f32 host buffer the batcher packs a launch
        into (pinned when the entry is on the card); one per bucket, reused
        by every launch there."""
        buf = self._host.get(bucket)
        if buf is None:
            buf = torch.zeros((bucket, self.n_features), dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._host[bucket] = buf
        return buf

    def plan(self, bucket: int) -> _GraphPlan | None:
        """The bucket's launch plan, built at first use: the eager
        :func:`~repro_torch.kernels.ops.warm_assign` (tuning, build; it
        raises if the kernel fails), then on the card the capture (the
        plan's ``graph``); None on the CPU, where the plan is the plain
        call."""
        if bucket not in self._plans:
            snap = self.snapshot()
            # One plan built at a time, process-wide: no eager launch of
            # another entry's warmup lands in a capture's launch count.
            with _build_lock:
                ops.warm_assign(bucket, snap.k, snap.n_features,
                                impl=self.impl, precision=self.precision,
                                device=self.device)
                self._plans[bucket] = (_GraphPlan(self, bucket)
                                       if self.device.type == "cuda"
                                       else None)
            self._recompiles += 1
        return self._plans[bucket]

    def launch(self, q, snapshot: CentroidSnapshot
               ) -> tuple[np.ndarray, np.ndarray]:
        """Run one coalesced assignment launch against ``snapshot``.

        ``q`` is the padded ``[bucket, n]`` f32 host buffer the batcher
        packed (:meth:`host_buffer`).  On the card its rows are copied into
        the bucket's static input, ``snapshot``'s centroids into the static
        centroid buffer when it is not the snapshot staged last, and the
        bucket's graph is replayed, all on the entry's stream; ids and
        distances come back to the host before this returns.  A method (not
        an inlined call) so tests can wrap it to simulate slow or failing
        kernels without touching the queueing logic.
        """
        return self._run(q, snapshot)

    def relaunch(self, q, snapshot: CentroidSnapshot
                 ) -> tuple[np.ndarray, np.ndarray]:
        """The launch a transient fault retries on: the same launch again
        (on the card the bucket's graph replayed, the kernel and never the
        plain version).  A method of its own, so that what wraps
        :meth:`launch` (``FaultPlan.wrap_launch``, a test's gate) leaves
        the retry alone, as the reference's ref-path retry is left alone."""
        return self._run(q, snapshot)

    def _run(self, q, snapshot: CentroidSnapshot
             ) -> tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(q)
        bucket = int(q.shape[0])
        plan = self.plan(bucket)
        self.replays[bucket] = self.replays.get(bucket, 0) + 1
        if plan is None:
            ids, d = ops.assign(q, snapshot.centroids, impl=self.impl,
                                precision=self.precision)
            return ids.numpy(), d.numpy()
        if snapshot is not self._staged:
            with torch.cuda.stream(self.stream):
                self.centroid_buffer.copy_(snapshot.centroids,
                                           non_blocking=True)
            self._staged = snapshot
        return plan(q, self.stream)

    def launch_fallback(self, q, snapshot: CentroidSnapshot
                        ) -> tuple[np.ndarray, np.ndarray]:
        """The reference's ref-path launch, where a demoted bucket runs:
        ``ops.assign(impl="ref")`` on the CPU.  An entry on the card has no
        plain route (its demoted buckets fail their requests, see
        :class:`~repro_torch.serve.batcher.Batcher`): there this raises."""
        if self.device.type != "cpu":
            raise RuntimeError(
                f"{self.model_id!r}: no plain fallback on {self.device}")
        ids, d = ops.assign(torch.as_tensor(q), snapshot.centroids,
                            impl="ref", precision=self.precision)
        return ids.numpy(), d.numpy()

    def demote_bucket(self, bucket: int, exc: Exception) -> None:
        """Take ``bucket`` of this entry off its kernel for its lifetime:
        on the CPU it runs :meth:`launch_fallback`, on the card its
        requests fail with ``LaunchFault``.

        The reference also records the failure in its process-wide kernel
        demotion table; the port keeps none (``kernels/ops.py``), so only
        this entry's bucket changes, reported in ``demoted_buckets`` and
        ``Server.health()``.
        """
        self._demoted_buckets.add(int(bucket))

    def is_demoted(self, bucket: int) -> bool:
        return int(bucket) in self._demoted_buckets

    @property
    def demoted_buckets(self) -> tuple[int, ...]:
        return tuple(sorted(self._demoted_buckets))

    def warmup(self, buckets: tuple[int, ...]) -> None:
        """Pre-pay every per-bucket cost off the request path: for each
        padded shape bucket, :func:`repro_torch.kernels.ops.warm_assign`
        (the autotune cache consulted and filled, the kernels built — a
        failing kernel raises) and the bucket's plan (the capture, on the
        card), so traffic never waits on either."""
        for b in buckets:
            self.plan(int(b))

    # -- snapshot management ------------------------------------------------
    def snapshot(self) -> CentroidSnapshot:
        """The current centroid generation (atomic read)."""
        with self._lock:
            return self._snapshot

    def swap(self, centroids, *, step: int | None = None) -> CentroidSnapshot:
        """Atomically replace the serving centroids.

        The new set must match the resident (k, n), so the per-bucket
        plans are reused as they are: a swap builds and validates the new
        device snapshot and writes one pointer — no capture — and in-flight
        requests are neither dropped nor re-queued: launches already in
        progress finish on the old snapshot, the next launch stages the new
        one.
        """
        arr = _as_centroids(centroids, self.device)
        with self._lock:
            old = self._snapshot
            if arr.shape != old.centroids.shape:
                raise ValueError(
                    f"swap shape mismatch for {self.model_id!r}: resident "
                    f"{tuple(old.centroids.shape)}, new {tuple(arr.shape)}")
            new = CentroidSnapshot(arr, version=old.version + 1, step=step)
            self._snapshot = new
        return new

    @property
    def recompiles(self) -> int:
        """Launch plans built: captures on the card, one per warmed bucket;
        must not grow under steady traffic or on a swap."""
        return self._recompiles


class ModelRegistry:
    """Thread-safe id -> :class:`ModelEntry` map with a swap trace; entries
    live on ``device`` (None: the card)."""

    def __init__(self, device=None):
        self.device = devices.resolve(device)
        self._lock = threading.Lock()
        self._entries: dict[str, ModelEntry] = {}
        self.trace: list = []

    def register(self, model_id: str, centroids, *, impl: str = "auto",
                 precision: str = "auto") -> ModelEntry:
        entry = ModelEntry(model_id, centroids, impl=impl,
                           precision=precision, device=self.device)
        with self._lock:
            if model_id in self._entries:
                raise ValueError(
                    f"model {model_id!r} already registered; use swap() to "
                    "replace its centroids")
            self._entries[model_id] = entry
        return entry

    def get(self, model_id: str) -> ModelEntry:
        with self._lock:
            try:
                return self._entries[model_id]
            except KeyError:
                raise KeyError(
                    f"unknown model {model_id!r}; registered: "
                    f"{sorted(self._entries)}") from None

    def unregister(self, model_id: str) -> None:
        with self._lock:
            self._entries.pop(model_id, None)

    def list_models(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def record(self, event: tuple) -> None:
        """Append a structured serving event to the trace (thread-safe).
        The batcher and circuit breaker route their ``launch_fault`` /
        ``deadline_shed`` / ``breaker_*`` / ``worker_restart`` events here."""
        with self._lock:
            self.trace.append(event)

    def swap(self, model_id: str, centroids, *,
             step: int | None = None) -> CentroidSnapshot:
        """Hot-swap ``model_id``'s centroids; logs ``("swap", id, step)``."""
        snap = self.get(model_id).swap(centroids, step=step)
        self.record(("swap", model_id, step))
        return snap
