"""Execution strategies: how a Big-means fit executes.

The reference registers ``sequential``, ``batched``, ``sharded`` and
``streaming`` behind ``fit(config, source, key) -> FitResult`` and resolves
``auto`` from the config, the source and the devices.  This slice ports
``sequential`` — the paper's Algorithm 3 — and ``auto``; the other
strategies raise ``NotImplementedError`` naming their ROADMAP item.
``auto`` resolves over the one device the caller gave, so an in-core source
goes to ``sequential``.
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
    "batched": "ROADMAP queue 1 item 5",
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


def resolve_auto(cfg: BigMeansConfig, source: DataSource) -> str:
    """Pick a strategy as the reference does, over one device.

    Out-of-core or stream-preferring sources go to ``streaming`` (not
    ported: ``fit`` then raises); everything else goes to ``sequential``
    (``batch > 1`` and multi-device topologies already raise in the
    config).
    """
    if not source.in_core or source.prefers_streaming:
        return "streaming"
    return "sequential"


def _fit_auto(cfg: BigMeansConfig, source: DataSource, key, *, rng,
              device) -> FitResult:
    result = get_strategy(resolve_auto(cfg, source))(
        cfg, source, key, rng=rng, device=device)
    result.extras["auto"] = True
    return result
