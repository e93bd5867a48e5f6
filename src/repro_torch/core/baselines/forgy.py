"""Forgy K-means (paper §5.2): uniform k-point init + full-data Lloyd."""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import kmeans


def forgy_kmeans(X: torch.Tensor, key, *, k: int, max_iters: int = 300,
                 tol: float = 1e-4, impl: str = "auto",
                 rng=rnd.TORCH) -> kmeans.KMeansResult:
    """k distinct rows of X as the start, then Lloyd on all of X (in X's
    dtype: a bf16 X runs at bf16 under ``precision='auto'``)."""
    idx = rng.choice(key, X.shape[0], k, X.device)
    return kmeans.lloyd(X, X[idx], max_iters=max_iters, tol=tol, impl=impl)
