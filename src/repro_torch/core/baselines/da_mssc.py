"""Decomposition/Aggregation MSSC (paper §5.4).

Phase 1: partition a sample of the data into q independent chunks, cluster
each into k clusters (K-means++ init + Lloyd: kernel A at [s, n] on the
card), pool all q*k centroids weighted by their cluster sizes.  Phase 2:
cluster the weighted pool into k.  The reference maps over the chunks
with ``lax.map``; here a loop takes them in the same order, with the same
keys.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import kmeans
from repro_torch.core.kmeanspp import kmeanspp


def da_mssc(X: torch.Tensor, key, *, k: int, s: int, q: int,
            candidates: int = 3, max_iters: int = 300, tol: float = 1e-4,
            impl: str = "auto", rng=rnd.TORCH) -> kmeans.KMeansResult:
    X = X.float()
    m, n = X.shape

    key, kperm = rng.split(key)
    idx = rng.randint(kperm, (q, s), 0, m, X.device)      # q chunks of size s
    keys = rng.split(key, q + 1)
    cents, counts = [], []
    for chunk_idx, chunk_key in zip(idx, keys[1:]):
        chunk = X[chunk_idx]
        c0 = kmeanspp(chunk, chunk_key, k, candidates=candidates,
                      impl=impl, rng=rng)
        res = kmeans.lloyd(chunk, c0, max_iters=max_iters, tol=tol,
                           impl=impl)
        cents.append(res.centroids)
        counts.append(res.counts)
    pool = torch.stack(cents).reshape(q * k, n)
    w = torch.stack(counts).reshape(q * k)

    c0 = kmeanspp(pool, keys[0], k, candidates=candidates, weights=w,
                  impl=impl, rng=rng)
    return kmeans.lloyd(pool, c0, weights=w, max_iters=max_iters, tol=tol,
                        impl=impl)
