"""Baseline registry: the paper's §5 competitors behind the same `fit()`.

Each entry is a ``fn(config, source, key, *, rng, device) -> FitResult``
wrapper over :mod:`repro_torch.core.baselines` — the strategies'
signature — so Big-means and its competitors are compared through one
interface, as in the reference's ``repro.api.baselines``.

Baselines are full-data (in-core) algorithms: a source that cannot be
materialized (a provider, an iterator) raises ``TypeError``.  The data is
moved to the fit's device once, in its storage (a bf16 tensor stays bf16,
anything else is f32).  Their ``objective`` is f(C, X) over the data they
actually clustered (the coreset baseline reports the weighted coreset
objective — evaluate on X for a like-for-like number).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.api.config import BigMeansConfig
from repro_torch.api.result import FitResult
from repro_torch.api.sources import DataSource

BaselineFn = Callable[..., FitResult]

_BASELINES: dict[str, BaselineFn] = {}


def register_baseline(name: str):
    """Decorator: register ``fn(config, source, key, *, rng, device)``."""
    def deco(fn: BaselineFn) -> BaselineFn:
        _BASELINES[name] = fn
        return fn
    return deco


def get_baseline(name: str) -> BaselineFn:
    try:
        return _BASELINES[name]
    except KeyError:
        raise KeyError(
            f"unknown baseline {name!r}; known: {list_baselines()}") from None


def list_baselines() -> list[str]:
    return sorted(_BASELINES)


def _array(source: DataSource, name: str, device: torch.device
           ) -> torch.Tensor:
    """The whole dataset on ``device``: bf16 if it is a bf16 tensor, else
    f32."""
    if not source.in_core:
        raise TypeError(
            f"baseline {name!r} is a full-data algorithm and needs in-core "
            f"data; {type(source).__name__} cannot be materialized")
    X = source.as_array()
    dtype = (torch.bfloat16 if devices.data_dtype(X) == torch.bfloat16
             else torch.float32)
    return devices.to_dtype(X, device, dtype)


def _from_kmeans_result(res, name: str, cfg: BigMeansConfig) -> FitResult:
    return FitResult(
        centroids=res.centroids,
        objective=float(res.objective),
        algorithm=name,
        strategy=None,
        n_chunks=0,
        n_accepted=0,
        n_iterations=int(res.iterations),
        n_dist_evals=math.nan,
        config=cfg,
        extras={"counts": res.counts.cpu().numpy()},
    )


@register_baseline("forgy")
def _fit_forgy(cfg, source, key, *, rng, device):
    from repro_torch.core.baselines import forgy_kmeans

    X = _array(source, "forgy", device)
    res = forgy_kmeans(X, key, k=cfg.k, max_iters=cfg.max_iters, tol=cfg.tol,
                       impl=cfg.impl, rng=rng)
    return _from_kmeans_result(res, "forgy", cfg)


@register_baseline("kmeanspp")
def _fit_kmeanspp(cfg, source, key, *, rng, device):
    """Multi-start K-means++ (the paper's "K-means++" competitor column)."""
    from repro_torch.core.baselines import multistart_kmeans

    X = _array(source, "kmeanspp", device)
    res = multistart_kmeans(
        X, key, k=cfg.k, n_init=3, init="kmeans++",
        candidates=cfg.candidates, max_iters=cfg.max_iters, tol=cfg.tol,
        impl=cfg.impl, rng=rng)
    return _from_kmeans_result(res, "kmeanspp", cfg)


@register_baseline("kmeans_parallel")
def _fit_kmeans_parallel(cfg, source, key, *, rng, device):
    from repro_torch.core.baselines import kmeans_parallel

    X = _array(source, "kmeans_parallel", device)
    res = kmeans_parallel(X, key, k=cfg.k, max_iters=cfg.max_iters,
                          tol=cfg.tol, impl=cfg.impl, rng=rng)
    return _from_kmeans_result(res, "kmeans_parallel", cfg)


@register_baseline("coreset")
def _fit_coreset(cfg, source, key, *, rng, device):
    from repro_torch.core.baselines import lightweight_coreset_kmeans

    X = _array(source, "coreset", device)
    res = lightweight_coreset_kmeans(
        X, key, k=cfg.k, s=cfg.s, candidates=cfg.candidates,
        max_iters=cfg.max_iters, tol=cfg.tol, impl=cfg.impl, rng=rng)
    out = _from_kmeans_result(res, "coreset", cfg)
    out.extras["objective_scope"] = "weighted coreset"
    return out


@register_baseline("da_mssc")
def _fit_da_mssc(cfg, source, key, *, rng, device):
    from repro_torch.core.baselines import da_mssc

    X = _array(source, "da_mssc", device)
    m = X.shape[0]
    q = max(1, min(cfg.n_chunks, m // cfg.s))
    res = da_mssc(X, key, k=cfg.k, s=cfg.s, q=q, candidates=cfg.candidates,
                  max_iters=cfg.max_iters, tol=cfg.tol, impl=cfg.impl,
                  rng=rng)
    out = _from_kmeans_result(res, "da_mssc", cfg)
    out.n_chunks = q
    return out


@register_baseline("ward")
def _fit_ward(cfg, source, key, *, rng, device):
    """Ward on the host (NumPy float64); its objective on ``device``."""
    from repro_torch.core.baselines import ward
    from repro_torch.core.objective import full_objective

    X = _array(source, "ward", device)
    centroids, labels = ward(devices.host_array(X, np.float64), cfg.k)
    centroids = torch.from_numpy(np.asarray(centroids, dtype=np.float32)
                                 ).to(device)
    f = float(full_objective(X.float(), centroids, impl=cfg.impl))
    return FitResult(
        centroids=centroids,
        objective=f,
        algorithm="ward",
        strategy=None,
        n_dist_evals=math.nan,
        config=cfg,
        extras={"labels": np.asarray(labels)},
    )
