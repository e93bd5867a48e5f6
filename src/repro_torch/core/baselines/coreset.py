"""Lightweight coresets (Bachem et al., paper §5.1 eq. (10))."""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import kmeans
from repro_torch.core.kmeanspp import kmeanspp


def sample(X: torch.Tensor, key, s: int, *, rng=rnd.TORCH
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw an s-row lightweight coreset of X with ``key``: its rows and
    their unbiased weights 1/(s q(x)), q(x) = 0.5/m + 0.5 d(x, mu)/sum d."""
    X = X.float()
    m = X.shape[0]
    mu = torch.mean(X, dim=0)
    dmu = torch.sum((X - mu) ** 2, dim=1)                   # two-pass: q(x)
    q = 0.5 / m + 0.5 * dmu / torch.clamp_min(torch.sum(dmu), 1e-30)
    idx = rng.categorical(key, torch.log(q), s, X.device)
    return X[idx], 1.0 / (s * q[idx])                      # unbiased weights


def lightweight_coreset_kmeans(X: torch.Tensor, key, *, k: int, s: int,
                               candidates: int = 3, max_iters: int = 300,
                               tol: float = 1e-4, impl: str = "auto",
                               rng=rnd.TORCH) -> kmeans.KMeansResult:
    """Build an (eps,k)-lightweight coreset of size s, cluster it weighted.

    The objective is the weighted coreset's; evaluate on X for the
    full-data one.
    """
    key, ks, kc = rng.split(key, 3)
    C, w = sample(X, ks, s, rng=rng)
    c0 = kmeanspp(C, kc, k, candidates=candidates, weights=w, impl=impl,
                  rng=rng)
    return kmeans.lloyd(C, c0, weights=w, max_iters=max_iters, tol=tol,
                        impl=impl)
