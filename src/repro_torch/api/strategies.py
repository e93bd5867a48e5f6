"""Execution strategies: how a Big-means fit executes.

The reference registers ``sequential``, ``batched``, ``sharded`` and
``streaming`` behind ``fit(config, source, key) -> FitResult`` and resolves
``auto`` from the config, the source and the devices.  The port runs
``sequential`` — the paper's Algorithm 3 — ``batched`` — B incumbent
streams on one device — and ``auto``; the other strategies raise
``NotImplementedError`` naming their ROADMAP item.  ``auto`` resolves over
the one device the caller gave: an in-core source goes to ``batched`` when
``batch > 1`` and to ``sequential`` otherwise.
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
    "streaming": "ROADMAP queue 1 item 6",
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
            f"{type(source).__name__}")
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
            f"{type(source).__name__}")
    state, infos = bigmeans.big_means_batched(
        source.as_array(), key, k=cfg.k, s=cfg.s, batch=cfg.batch,
        rounds=rounds, sync_every=sync_every, max_iters=cfg.max_iters,
        tol=cfg.tol, candidates=cfg.candidates, impl=cfg.impl,
        with_replacement=cfg.with_replacement, precision=cfg.precision,
        rng=rng, device=device)
    return _result_from_state(state, infos, cfg, "batched",
                              batch=cfg.batch, rounds=rounds)


def resolve_auto(cfg: BigMeansConfig, source: DataSource) -> str:
    """Pick a strategy as the reference does, over one device.

    Out-of-core or stream-preferring sources go to ``streaming`` (not
    ported: ``fit`` then raises); ``batch > 1`` goes to ``batched``;
    everything else to ``sequential`` (multi-device topologies and the
    runner-only knobs already raise in the config).
    """
    if not source.in_core or source.prefers_streaming:
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
