"""Multi-start K-means: n_init restarts (Forgy or K-means++ init), keep best.

This is the paper's "K-means++" competitor column when ``init='kmeans++'``
and the classical multi-start K-means when ``init='forgy'``.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import kmeans
from repro_torch.core.kmeanspp import kmeanspp


def multistart_kmeans(X: torch.Tensor, key, *, k: int, n_init: int = 3,
                      init: str = "kmeans++", candidates: int = 3,
                      max_iters: int = 300, tol: float = 1e-4,
                      impl: str = "auto",
                      rng=rnd.TORCH) -> kmeans.KMeansResult:
    """One start per key of ``split(key, n_init)``; the best objective
    wins, the earliest start on a tie (the reference's ``lax.scan`` takes
    a later start only when it is strictly better)."""
    if init not in ("kmeans++", "forgy"):
        raise ValueError(init)
    best = None
    for start in rng.split(key, n_init):
        if init == "kmeans++":
            c0 = kmeanspp(X, start, k, candidates=candidates, impl=impl,
                          rng=rng)
        else:
            c0 = X[rng.choice(start, X.shape[0], k, X.device)]
        res = kmeans.lloyd(X, c0, max_iters=max_iters, tol=tol, impl=impl)
        if best is None or bool(res.objective < best.objective):
            best = res
    return best
