"""Execution strategies: how a Big-means fit executes.

The reference registers ``sequential``, ``batched``, ``sharded`` and
``streaming`` behind ``fit(config, source, key) -> FitResult`` and resolves
``auto`` from the config, the source and the devices.  The port runs
``sequential`` — the paper's Algorithm 3 — ``batched`` — B incumbent
streams on one device — ``streaming`` — the out-of-core loop over chunks
fetched from the source (:mod:`repro_torch.engine.stream`) — and ``auto``;
``sharded`` raises ``NotImplementedError`` naming its ROADMAP item.
``auto`` resolves over the one device the caller gave: an out-of-core or
stream-preferring source (an ``.npy`` path, a provider callable, a chunk
iterator), or a knob only the stream loop runs (``ckpt_dir``,
``time_budget_s``, ``vns_ladder``, ``scheduler="competitive_s"``), goes to
``streaming``, an
in-core one to ``batched`` when ``batch > 1`` and to ``sequential``
otherwise.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.api.config import BigMeansConfig
from repro_torch.api.result import FitResult
from repro_torch.api.sources import DataSource

StrategyFn = Callable[..., FitResult]

_STRATEGIES: dict[str, StrategyFn] = {}

NOT_PORTED = {
    "sharded": "ROADMAP queue 1 item 8",
}


def register_strategy(name: str):
    """Decorator: register ``fn(config, source, key, *, rng, device)``."""
    def deco(fn: StrategyFn) -> StrategyFn:
        _STRATEGIES[name] = fn
        return fn
    return deco


def get_strategy(name: str) -> StrategyFn:
    if name == "auto":
        return _fit_auto
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet ({NOT_PORTED[name]})")
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; known: "
            f"{['auto'] + list_strategies()}") from None


def list_strategies() -> list[str]:
    return sorted(_STRATEGIES)


def _result_from_state(state, infos, cfg, strategy, **extras) -> FitResult:
    f_new = infos.f_new.double().cpu().numpy()
    accepted = infos.accepted.cpu().numpy()
    return FitResult(
        centroids=state.centroids,
        objective=float(state.f_best),
        algorithm="big_means",
        strategy=strategy,
        n_chunks=int(f_new.size),
        n_accepted=int(state.n_accepted),
        n_iterations=int(np.sum(infos.lloyd_iters.cpu().numpy())),
        n_dist_evals=float(state.n_dist_evals),
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

    if not source.in_core:
        raise TypeError(
            f"strategy 'sequential' needs in-core data, got "
            f"{type(source).__name__}; use the 'streaming' strategy (or "
            "'auto', which picks it)")
    state, infos = bigmeans.big_means(
        source.as_array(), key, k=cfg.k, s=cfg.s, n_chunks=cfg.n_chunks,
        max_iters=cfg.max_iters, tol=cfg.tol, candidates=cfg.candidates,
        impl=cfg.impl, with_replacement=cfg.with_replacement,
        precision=cfg.precision, rng=rng, device=device)
    return _result_from_state(state, infos, cfg, "sequential")


@register_strategy("batched")
def _fit_batched(cfg: BigMeansConfig, source: DataSource, key, *, rng,
                 device) -> FitResult:
    from repro_torch.core import bigmeans

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
    if not source.in_core:
        raise TypeError(
            f"strategy 'batched' needs in-core data, got "
            f"{type(source).__name__}; use the 'streaming' strategy (or "
            "'auto', which picks it)")
    state, infos = bigmeans.big_means_batched(
        source.as_array(), key, k=cfg.k, s=cfg.s, batch=cfg.batch,
        rounds=rounds, sync_every=sync_every, max_iters=cfg.max_iters,
        tol=cfg.tol, candidates=cfg.candidates, impl=cfg.impl,
        with_replacement=cfg.with_replacement, precision=cfg.precision,
        rng=rng, device=device)
    return _result_from_state(state, infos, cfg, "batched",
                              batch=cfg.batch, rounds=rounds)


@register_strategy("streaming")
def _fit_streaming(cfg: BigMeansConfig, source: DataSource, key, *, rng,
                   device) -> FitResult:
    from repro_torch.engine import scheduler as sched_lib
    from repro_torch.engine import stream
    from repro_torch.kernels import precision as px

    scheduler = sched_lib.get_scheduler(cfg.scheduler, cfg)
    # competitive_s fetches at max(ladder) and slices per stream
    provider = source.provider(scheduler.fetch_s, seed=cfg.seed,
                               with_replacement=cfg.with_replacement)
    # 'auto' follows the source's dtype (bf16 for a bf16 tensor); the
    # loop stages its chunks in that policy's storage
    prec = px.resolve(cfg.precision, source.data_dtype)
    run_cfg = cfg if cfg.precision == prec else cfg.replace(precision=prec)
    state, metrics = stream.run_stream(
        provider, run_cfg, n_features=source.n_features, resume=cfg.resume,
        key=key, scheduler=scheduler, rng=rng, device=device)
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
    if isinstance(scheduler, sched_lib.CompetitiveS):
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


def resolve_auto(cfg: BigMeansConfig, source: DataSource) -> str:
    """Pick a strategy as the reference does, over one device.

    Out-of-core or stream-preferring sources and the stream-loop-only
    knobs (checkpoints, the time budget, VNS, ``competitive_s``) go to
    ``streaming``; ``batch > 1`` goes to ``batched``; everything else to
    ``sequential`` (multi-device topologies, queue 1 item 8, still raise in
    the config; so does the reference's in-core mesh with checkpoints,
    which it sends to ``sharded``).
    """
    wants_runner = (cfg.ckpt_dir is not None or cfg.time_budget_s is not None
                    or bool(cfg.vns_ladder)
                    or cfg.scheduler == "competitive_s")
    if not source.in_core or source.prefers_streaming or wants_runner:
        return "streaming"
    if cfg.batch > 1:
        return "batched"
    return "sequential"


def _fit_auto(cfg: BigMeansConfig, source: DataSource, key, *, rng,
              device) -> FitResult:
    result = get_strategy(resolve_auto(cfg, source))(
        cfg, source, key, rng=rng, device=device)
    result.extras["auto"] = True
    return result
