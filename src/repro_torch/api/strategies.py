"""Execution strategies: how a Big-means fit executes.

The reference's registry behind ``fit(config, source, key) -> FitResult``:

* ``sequential`` — the paper's Algorithm 3: one device, one stream
  (``engine.incore.sequential``).
* ``batched`` — B incumbent streams (``engine.incore.batched_local``;
  with ``topology='stream_mesh'`` the streams are split into groups over a
  device mesh, ``batched_stream_mesh``).
* ``sharded`` — one chunk stream per worker of a worker mesh with a
  periodic incumbent exchange (``engine.incore.worker_sharded``); with
  checkpoints or a time budget the same windows run with the middleware
  stack between them (``worker_sharded_rounds``).
* ``streaming`` — the out-of-core loop over chunks fetched from the source
  (:mod:`repro_torch.engine.stream`), on one device, with the stream mesh,
  or scaled out over processes (``topology='host_mesh'`` →
  :func:`repro_torch.engine.hostmesh.run_host_stream`).
* ``auto`` — picks one from the config, the source and the devices the
  caller gave: an out-of-core or stream-preferring source (an ``.npy``
  path, a provider callable, a chunk iterator), or a knob only the stream
  loop runs (``ckpt_dir``, ``time_budget_s``, ``vns_ladder``,
  ``scheduler="competitive_s"``), goes to ``streaming`` (an in-core worker
  mesh with checkpoints to ``sharded``); ``batch > 1`` to ``batched``; a
  worker mesh, or a run that sees more than one device, to ``sharded``
  (with a ``sync_every`` adjusted to divide the per-worker chunks); the
  rest to ``sequential``.

Placement is declarative: strategies read ``cfg.topology`` through
:func:`repro_torch.engine.topology.from_config` and never build meshes;
the deprecated raw ``cfg.mesh`` rides the same path through the shim.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch import tracing
from repro_torch.api.config import BigMeansConfig
from repro_torch.api.result import FitResult
from repro_torch.api.sources import DataSource

StrategyFn = Callable[..., FitResult]

_STRATEGIES: dict[str, StrategyFn] = {}


def register_strategy(name: str):
    """Decorator: register ``fn(config, source, key, *, rng, device)``."""
    def deco(fn: StrategyFn) -> StrategyFn:
        _STRATEGIES[name] = fn
        return fn
    return deco


def get_strategy(name: str) -> StrategyFn:
    if name == "auto":
        return _fit_auto
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; known: "
            f"{['auto'] + list_strategies()}") from None


def list_strategies() -> list[str]:
    return sorted(_STRATEGIES)


def _require_array(source: DataSource, strategy: str):
    if not source.in_core:
        raise TypeError(
            f"strategy {strategy!r} needs in-core data, got "
            f"{type(source).__name__}; use the 'streaming' strategy (or "
            "'auto', which picks it)")
    return source.as_array()


def _largest_divisor_le(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _result_from_state(state, infos, cfg, strategy, **extras) -> FitResult:
    with tracing.span("api.strategies.result", state.f_best):
        f_new = infos.f_new.double().cpu().numpy()
        accepted = infos.accepted.cpu().numpy()
        objective = float(state.f_best)
        n_accepted = int(state.n_accepted)
        n_dist_evals = float(state.n_dist_evals)
        # the sequential loops count Lloyd's iterations on the host
        iters = infos.lloyd_iters
        tracing.count("host_sync.api.result",
                      5 + (iters.device.type != "cpu"))
        n_iterations = int(np.sum(iters.cpu().numpy()))
    return FitResult(
        centroids=state.centroids,
        objective=objective,
        algorithm="big_means",
        strategy=strategy,
        n_chunks=int(f_new.size),
        n_accepted=n_accepted,
        n_iterations=n_iterations,
        n_dist_evals=n_dist_evals,
        trace=[(int(i), float(f), bool(a))
               for i, (f, a) in enumerate(zip(f_new, accepted))],
        config=cfg,
        extras=extras,
    )


def _resolve_sync_every(cfg: BigMeansConfig, rounds: int) -> int:
    """Concrete exchange period from the sync-policy knob (``'competitive'``
    resolves to a single final exchange)."""
    from repro_torch.engine import sync as sync_lib

    return sync_lib.from_config(cfg).resolve(rounds)


@register_strategy("sequential")
def _fit_sequential(cfg: BigMeansConfig, source: DataSource, key, *, rng,
                    device) -> FitResult:
    from repro_torch.core import bigmeans

    X = _require_array(source, "sequential")
    state, infos = bigmeans.big_means(
        X, key, k=cfg.k, s=cfg.s, n_chunks=cfg.n_chunks,
        max_iters=cfg.max_iters, tol=cfg.tol, candidates=cfg.candidates,
        impl=cfg.impl, with_replacement=cfg.with_replacement,
        precision=cfg.precision, rng=rng, device=device)
    return _result_from_state(state, infos, cfg, "sequential")


@register_strategy("batched")
def _fit_batched(cfg: BigMeansConfig, source: DataSource, key, *, rng,
                 device) -> FitResult:
    from repro_torch.core import bigmeans
    from repro_torch.engine import topology as topo_lib

    if cfg.n_chunks % cfg.batch:
        raise ValueError(
            f"strategy 'batched' needs batch ({cfg.batch}) to divide "
            f"n_chunks ({cfg.n_chunks})")
    rounds = cfg.n_chunks // cfg.batch
    sync_every = _resolve_sync_every(cfg, rounds)
    if rounds % sync_every:
        raise ValueError(
            f"strategy 'batched' needs sync_every ({sync_every}) to "
            f"divide the round count ({rounds} = n_chunks / batch)")
    topo = topo_lib.for_streams(cfg, device)
    if not isinstance(topo, (topo_lib.SingleDevice, topo_lib.StreamMesh)):
        raise ValueError(
            f"strategy 'batched' runs on 'single' or 'stream_mesh' "
            f"topologies, got {topo.name!r}")
    mesh = topo.mesh if isinstance(topo, topo_lib.StreamMesh) else None
    if mesh is not None and cfg.batch % topo.devices:
        raise ValueError(
            f"stream mesh has {topo.devices} devices, which must "
            f"divide batch ({cfg.batch})")
    X = _require_array(source, "batched")
    state, infos = bigmeans.big_means_batched(
        X, key, k=cfg.k, s=cfg.s, batch=cfg.batch,
        rounds=rounds, sync_every=sync_every, max_iters=cfg.max_iters,
        tol=cfg.tol, candidates=cfg.candidates, impl=cfg.impl,
        with_replacement=cfg.with_replacement, precision=cfg.precision,
        rng=rng, device=device, mesh=mesh,
        stream_axis=topo.axis if mesh is not None else cfg.stream_axis)
    return _result_from_state(state, infos, cfg, "batched",
                              batch=cfg.batch, rounds=rounds)


@register_strategy("sharded")
def _fit_sharded(cfg: BigMeansConfig, source: DataSource, key, *, rng,
                 device) -> FitResult:
    from repro_torch.engine import incore, middleware as mw
    from repro_torch.engine import topology as topo_lib

    spec = cfg.topology
    if cfg.mesh is None and spec.kind == "auto" \
            and tuple(cfg.mesh_axes[:1]) != ("data",):
        # legacy axis-name knob without a mesh: honour it through the spec
        spec = topo_lib.TopologySpec(kind="worker_mesh",
                                     axes=tuple(cfg.mesh_axes[:1]))
        topo = topo_lib.resolve(spec, role="worker", device=device)
    else:
        topo = topo_lib.for_workers(cfg, device=device)
    workers = topo.devices
    if cfg.n_chunks % workers:
        raise ValueError(
            f"strategy 'sharded' needs the worker count ({workers}) to "
            f"divide n_chunks ({cfg.n_chunks})")
    chunks_per_worker = cfg.n_chunks // workers
    sync_every = _resolve_sync_every(cfg, chunks_per_worker)
    if chunks_per_worker % sync_every:
        raise ValueError(
            f"strategy 'sharded' needs sync_every ({sync_every}) to "
            f"divide chunks_per_worker ({chunks_per_worker} = "
            f"n_chunks / workers)")

    X = _require_array(source, "sharded")
    kwargs = dict(
        mesh=topo.mesh, k=cfg.k, s=cfg.s,
        chunks_per_worker=chunks_per_worker, sync_every=sync_every,
        axes=topo.axes, max_iters=cfg.max_iters, tol=cfg.tol,
        candidates=cfg.candidates, impl=cfg.impl,
        with_replacement=cfg.with_replacement, precision=cfg.precision,
        rng=rng)
    extras = dict(workers=workers, chunks_per_worker=chunks_per_worker)
    if cfg.ckpt_dir is None and cfg.time_budget_s is None:
        state, infos = incore.worker_sharded(X, key, **kwargs)
        return _result_from_state(state, infos, cfg, "sharded", **extras)
    # middleware composition (checkpoint / resume, time budget): the same
    # windows with the stack between them
    mws: list = []
    if cfg.ckpt_dir:
        mws.append(mw.Checkpoint(cfg.ckpt_dir, cfg.ckpt_every, sync_every,
                                 step_from="step"))
    if cfg.time_budget_s is not None:
        mws.append(mw.TimeBudget(cfg.time_budget_s))
    state, infos, ctx = incore.worker_sharded_rounds(
        X, key, cfg=cfg, middlewares=mws, resume=cfg.resume, **kwargs)
    result = _result_from_state(state, infos, cfg, "sharded",
                                rounds_done=ctx.step, **extras)
    result.trace.extend(ctx.metrics.trace)
    result.checkpoint_dir = cfg.ckpt_dir
    if cfg.ckpt_dir is not None:
        result.extras["checkpoint"] = ctx.metrics.checkpoint
    return result


@register_strategy("streaming")
def _fit_streaming(cfg: BigMeansConfig, source: DataSource, key, *, rng,
                   device) -> FitResult:
    from repro_torch.engine import hostmesh
    from repro_torch.engine import scheduler as sched_lib
    from repro_torch.engine import stream
    from repro_torch.engine import topology as topo_lib
    from repro_torch.kernels import precision as px

    topology = topo_lib.for_streams(cfg, device)
    scheduler = sched_lib.get_scheduler(cfg.scheduler, cfg)
    # competitive_s fetches at max(ladder) and slices per stream
    provider = source.provider(scheduler.fetch_s, seed=cfg.seed,
                               with_replacement=cfg.with_replacement)
    # 'auto' follows the source's dtype (bf16 for a bf16 tensor); the
    # loop stages its chunks in that policy's storage
    prec = px.resolve(cfg.precision, source.data_dtype)
    run_cfg = cfg if cfg.precision == prec else cfg.replace(precision=prec)
    if isinstance(topology, topo_lib.HostMesh):
        # multi-host scale-out: this process runs its chunk-id shard and
        # exchanges incumbents at sync windows (run_host_stream builds the
        # rank-local scheduler, so the config-level one is discarded)
        state, metrics = hostmesh.run_host_stream(
            provider, run_cfg, topology=topology,
            n_features=source.n_features, resume=cfg.resume, key=key,
            rng=rng, device=device)
    else:
        state, metrics = stream.run_stream(
            provider, run_cfg, n_features=source.n_features,
            resume=cfg.resume, key=key, scheduler=scheduler,
            topology=topology, rng=rng, device=device)
    extras = {"chunks_failed": metrics.chunks_failed,
              "chunks_dropped": metrics.chunks_dropped,
              "chunks_quarantined": metrics.chunks_quarantined}
    # Run-health summary: the reconciliation contract in one record —
    # done + failed + dropped + quarantined == chunks fetched.
    extras["health"] = {
        "chunks_done": metrics.chunks_done,
        "chunks_failed": metrics.chunks_failed,
        "chunks_dropped": metrics.chunks_dropped,
        "chunks_quarantined": metrics.chunks_quarantined,
        "chunks_fetched": (metrics.chunks_done + metrics.chunks_failed
                           + metrics.chunks_dropped
                           + metrics.chunks_quarantined),
        "ckpt_fallback": next(
            (t[1] for t in metrics.trace if t[0] == "ckpt_fallback"), None),
        "quarantine_reasons": [
            (t[1], t[2]) for t in metrics.trace if t[0] == "quarantine"],
    }
    if metrics.host is not None:
        # the final cross-host gather: every rank's reconciliation record
        extras["health"]["ranks"] = metrics.host["per_rank"]
        extras["host"] = {k: metrics.host[k]
                          for k in ("rank", "processes", "winner_rank")}
    elif isinstance(scheduler, sched_lib.CompetitiveS):
        extras["competitive_s"] = {
            "ladder": scheduler.ladder,
            "final_sizes": list(scheduler.s_of),
            "windows": len(scheduler.history),
        }
    extras["pipeline"] = metrics.pipeline
    if cfg.ckpt_dir is not None:
        extras["checkpoint"] = metrics.checkpoint
    return FitResult(
        centroids=state.centroids,
        objective=float(state.f_best),
        algorithm="big_means",
        strategy="streaming",
        n_chunks=metrics.chunks_done,
        n_accepted=metrics.accepted,
        n_iterations=metrics.lloyd_iters,
        n_dist_evals=float(state.n_dist_evals),
        wall_time_s=metrics.wall_time_s,
        trace=list(metrics.trace),
        checkpoint_dir=cfg.ckpt_dir,
        config=cfg,
        extras=extras,
    )


def resolve_auto(cfg: BigMeansConfig, source: DataSource,
                 device=None) -> str:
    """Pick a concrete strategy from the config, the data source and the
    devices a run on ``device`` sees (the reference's rule).

    Out-of-core or stream-shaped sources and the stream-loop-only knobs
    (checkpoints, the time budget, VNS, ``competitive_s``) go to
    ``streaming`` — an in-core worker mesh with checkpoints to
    ``sharded``; ``batch > 1`` goes to ``batched``; a worker mesh, or a
    run that sees more than one device, to ``sharded`` when the worker
    count divides ``n_chunks`` (deriving a compatible ``sync_every`` when
    the requested one does not divide the per-worker chunk count — see
    :func:`_fit_auto`); otherwise the paper's ``sequential``.
    """
    from repro_torch.engine import topology as topo_lib

    kind = topo_lib.requested_kind(cfg)
    if kind == "host_mesh":
        return "streaming"          # host_mesh is a streaming-only topology
    worker_kind = kind in ("legacy_mesh", "worker_mesh")
    wants_runner = (cfg.ckpt_dir is not None or cfg.time_budget_s is not None
                    or bool(cfg.vns_ladder)
                    or cfg.scheduler == "competitive_s")
    if not source.in_core or source.prefers_streaming or wants_runner:
        if cfg.ckpt_dir is not None and source.in_core \
                and not source.prefers_streaming and cfg.batch == 1 \
                and not cfg.vns_ladder and cfg.scheduler == "uniform" \
                and worker_kind \
                and cfg.n_chunks % topo_lib.worker_count(cfg, device) == 0:
            return "sharded"        # in-core mesh + checkpoints
        return "streaming"
    if cfg.batch > 1:
        return "batched"
    if worker_kind or (kind == "auto"
                       and topo_lib._local_device_count(device) > 1):
        if cfg.n_chunks % topo_lib.worker_count(cfg, device) == 0:
            return "sharded"
    return "sequential"


def _fit_auto(cfg: BigMeansConfig, source: DataSource, key, *, rng,
              device) -> FitResult:
    from repro_torch.engine import topology as topo_lib

    name = resolve_auto(cfg, source, device)
    extras = {}
    if name == "sharded":
        workers = topo_lib.worker_count(cfg, device)
        chunks_per_worker = cfg.n_chunks // workers
        if chunks_per_worker % cfg.sync_every:
            # auto never downgrades a multi-device run to sequential over
            # an incompatible sync_every: derive the largest compatible one
            used = _largest_divisor_le(chunks_per_worker, cfg.sync_every)
            extras["sync_every_adjusted"] = {
                "requested": cfg.sync_every, "used": used}
            cfg = cfg.replace(sync_every=used)
    result = _STRATEGIES[name](cfg, source, key, rng=rng, device=device)
    result.extras["auto"] = True
    result.extras.update(extras)
    return result
