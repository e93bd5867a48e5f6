"""`Server` — the assembled serving subsystem, and the `serve()` entry point.

The port of the reference's ``repro.serve.server``.  Wiring: ``Server``
owns one :class:`~repro_torch.serve.registry.ModelRegistry` (tenancy +
hot-swap) and one :class:`~repro_torch.serve.batcher.Batcher` per model
(coalescing + admission), plus any :class:`CheckpointWatcher` threads.
``repro_torch.api.serve()`` is the facade constructor::

    from repro_torch.api import ServeConfig, fit, serve

    result = fit(X, k=25, s=8192, ckpt_dir="ckpt")
    with serve({"prod": result}, ServeConfig(max_linger_ms=2.0)) as srv:
        srv.watch("prod", "ckpt")                  # hot-swap on new ckpts
        resp = srv.assign("prod", queries)         # -> AssignResponse

A server runs on the card unless ``device="cpu"`` is passed (then every
launch is the plain PyTorch version), and raises without a card.
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError

from repro_torch.serve.batcher import AssignResponse, Batcher
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.registry import (
    CentroidSnapshot, ModelEntry, ModelRegistry,
)
from repro_torch.serve.resilience import CLOSED, DeadlineExceeded
from repro_torch.serve.swap import CheckpointWatcher, swap_from_checkpoint


class Server:
    """A running multi-model assignment service (in-process), on
    ``device`` (None: the card)."""

    def __init__(self, config: ServeConfig | None = None, *, device=None):
        self.config = config or ServeConfig()
        self.registry = ModelRegistry(device)
        self.device = self.registry.device
        self._batchers: dict[str, Batcher] = {}
        self._watchers: list[CheckpointWatcher] = []
        self._closed = False

    # -- tenancy ------------------------------------------------------------
    def register(self, model_id: str, centroids, *, impl: str | None = None,
                 precision: str | None = None,
                 warmup: bool | None = None) -> ModelEntry:
        """Make ``model_id`` servable.  ``centroids`` is a [k, n] array or
        anything with a ``.centroids`` field (e.g. a ``FitResult``).

        ``impl`` / ``precision`` default to the server config (so tenants
        can run different precision policies side by side); with ``warmup``
        every shape bucket is tuned, built and captured now, off the
        request path.  A kernel that fails there raises, and the model is
        not registered.
        """
        cfg = self.config
        entry = self.registry.register(
            model_id, centroids,
            impl=cfg.impl if impl is None else impl,
            precision=cfg.precision if precision is None else precision)
        if cfg.warmup if warmup is None else warmup:
            try:
                entry.warmup(cfg.buckets())
            except BaseException:
                self.registry.unregister(model_id)
                raise
        self._batchers[model_id] = Batcher(entry, cfg,
                                           trace=self.registry.record)
        return entry

    def unregister(self, model_id: str) -> None:
        batcher = self._batchers.pop(model_id, None)
        if batcher is not None:
            batcher.close()
        self.registry.unregister(model_id)

    def models(self) -> list[str]:
        return self.registry.list_models()

    # -- request path -------------------------------------------------------
    def _batcher(self, model_id: str) -> Batcher:
        try:
            return self._batchers[model_id]
        except KeyError:
            raise KeyError(
                f"unknown model {model_id!r}; registered: "
                f"{self.models()}") from None

    def submit(self, model_id: str, points, *,
               deadline_ms: float | None = None, tenant: str = "default",
               validate: bool | None = None) -> Future:
        """Enqueue a request; returns ``Future[AssignResponse]``.

        Admission is fail-fast and typed: :class:`QueueFull` on a saturated
        queue, :class:`QuotaExceeded` when ``tenant`` is over its quota,
        :class:`ModelUnhealthy` while the model's circuit breaker is open,
        :class:`InvalidRequest` for non-finite payloads, and
        ``KeyError`` for unknown models.  ``deadline_ms`` overrides
        ``config.default_deadline_ms`` for this request.
        """
        return self._batcher(model_id).submit(
            points, deadline_ms=deadline_ms, tenant=tenant,
            validate=validate)

    def assign(self, model_id: str, points,
               timeout: float | None = 60.0, *,
               deadline_ms: float | None = None, tenant: str = "default",
               validate: bool | None = None) -> AssignResponse:
        """Synchronous convenience wrapper around :meth:`submit`.

        On ``timeout`` the queued request is *cancelled* — it will not
        burn a launch slot later, and its latency never enters the
        percentiles a client didn't observe — and
        :class:`DeadlineExceeded` is raised.
        """
        batcher = self._batcher(model_id)
        fut = batcher.submit(points, deadline_ms=deadline_ms, tenant=tenant,
                             validate=validate)
        try:
            return fut.result(timeout=timeout)
        except FutureTimeoutError:
            batcher.cancel(fut)
            raise DeadlineExceeded(
                f"model {model_id!r}: assign() timed out after {timeout}s; "
                "request cancelled") from None

    # -- hot-swap -----------------------------------------------------------
    def swap(self, model_id: str, centroids, *,
             step: int | None = None) -> CentroidSnapshot:
        """Atomically replace ``model_id``'s serving centroids."""
        return self.registry.swap(model_id, centroids, step=step)

    def swap_from_checkpoint(self, model_id: str, ckpt_dir: str, *,
                             step: int | None = None) -> CentroidSnapshot:
        """Refresh from the newest intact (SHA-256-verified) checkpoint."""
        return swap_from_checkpoint(self.registry, model_id, ckpt_dir,
                                    step=step)

    def watch(self, model_id: str, ckpt_dir: str, *,
              poll_interval_s: float | None = None,
              poll_timeout_s: float | None = None) -> CheckpointWatcher:
        """Start a background watcher hot-swapping ``model_id`` whenever a
        newer intact checkpoint appears under ``ckpt_dir``.  Polls run
        under the ``config.watcher_timeout_s`` watchdog (overridable here)
        so a hung checkpoint load can never freeze hot-swap."""
        watcher = CheckpointWatcher(
            self.registry, model_id, ckpt_dir,
            poll_interval_s=poll_interval_s or self.config.poll_interval_s,
            poll_timeout_s=(self.config.watcher_timeout_s
                            if poll_timeout_s is None else poll_timeout_s))
        self._watchers.append(watcher)
        return watcher.start()

    # -- telemetry ----------------------------------------------------------
    @property
    def trace(self) -> list:
        """Structured serving events (currently ``("swap", id, step)``)."""
        return self.registry.trace

    def stats(self, model_id: str | None = None) -> dict:
        """Per-model serving stats: latency percentiles, batch shapes,
        rejection counters, ``recompiles`` (launch plans built: CUDA graph
        captures on the card) and ``replays`` (launches per bucket)."""
        def one(mid: str) -> dict:
            entry = self.registry.get(mid)
            out = self._batchers[mid].stats.to_dict()
            snap = entry.snapshot()
            out.update({
                "model_id": mid,
                "k": snap.k,
                "n_features": snap.n_features,
                "version": snap.version,
                "step": snap.step,
                "impl": entry.impl,
                "precision": entry.precision,
                "recompiles": entry.recompiles,
                "n_swaps": snap.version,
                "replays": dict(sorted(entry.replays.items())),
            })
            return out

        if model_id is not None:
            return one(model_id)
        return {mid: one(mid) for mid in self.models()}

    def recompiles(self, model_id: str) -> int:
        return self.registry.get(model_id).recompiles

    def health(self) -> dict:
        """One aggregated liveness/readiness snapshot of the whole server.

        Per model: queue depth, circuit-breaker state, worker liveness and
        restart count, demoted buckets, and the age of the serving
        snapshot; plus every watcher's :meth:`CheckpointWatcher.describe`.
        ``ok`` is True iff every breaker is closed, every worker and
        watcher thread is alive, and no watcher poll is currently stalled.
        """
        now = time.monotonic()
        models = {}
        ok = not self._closed
        for mid in self.models():
            entry = self.registry.get(mid)
            batcher = self._batchers[mid]
            snap = entry.snapshot()
            breaker = batcher.breaker.describe()
            alive = batcher.worker_alive()
            models[mid] = {
                "queue_depth": batcher.queue_depth(),
                "breaker": breaker,
                "worker_alive": alive,
                "worker_restarts": batcher.stats.worker_restarts,
                "demoted_buckets": list(entry.demoted_buckets),
                "version": snap.version,
                "step": snap.step,
                "last_swap_age_s": round(now - snap.t_swapped, 3),
            }
            ok = ok and alive and breaker["state"] == CLOSED
        watchers = [w.describe() for w in self._watchers]
        for w in watchers:
            ok = ok and w["alive"] and not (
                w["last_error"] or "").startswith("poll stalled")
        return {"ok": ok, "models": models, "watchers": watchers}

    # -- lifecycle ----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop watchers, drain (or abort) queues, stop workers."""
        if self._closed:
            return
        self._closed = True
        for watcher in self._watchers:
            watcher.stop()
        for batcher in self._batchers.values():
            batcher.close(drain=drain)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(models: dict | None = None,
          config: ServeConfig | None = None, device=None,
          **overrides) -> Server:
    """Build and return a running :class:`Server`.

    * ``models`` — optional ``{model_id: centroids_or_FitResult}`` to
      register up front (each fully warmed before the call returns, so the
      first request never pays a build, a tuning or a capture).  If one
      fails to register, the server is closed and the error raised.
    * ``config`` / ``overrides`` — a :class:`ServeConfig`, with field
      overrides applied on top (``serve(models, max_linger_ms=5.0)``).
    * ``device`` — None serves on the card (raises without one);
      ``"cpu"`` serves the plain PyTorch path on the CPU.
    """
    cfg = config or ServeConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    server = Server(cfg, device=device)
    try:
        for model_id, centroids in (models or {}).items():
            server.register(model_id, centroids)
    except BaseException:
        server.close(drain=False)
        raise
    return server
