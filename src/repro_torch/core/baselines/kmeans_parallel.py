"""K-means|| (Bahmani et al., paper §5.3) — scalable K-means++.

The reference's fixed-shape adaptation: each of ``rounds`` rounds draws
exactly ``l`` points from the D² distribution (with replacement), where
the original samples each point with probability min(1, l*d(x)/phi).
Paper settings: l = 2k, r = 5 rounds.  The pool's weights are the counts
of its nearest points (kernels B and C on the card at k = 1 + l*r), then a
weighted K-means++ and a weighted Lloyd reduce it to k, and a last Lloyd
runs on the full data from there.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import kmeans
from repro_torch.core.kmeanspp import kmeanspp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kpp_probe import d2_logits


def kmeans_parallel(X: torch.Tensor, key, *, k: int, l: int | None = None,
                    rounds: int = 5, max_iters: int = 300,
                    tol: float = 1e-4, impl: str = "auto",
                    rng=rnd.TORCH) -> kmeans.KMeansResult:
    X = X.float()
    m, n = X.shape
    dev = X.device
    if l is None:
        l = 2 * k                                    # paper's optimal setting

    key, k0 = rng.split(key)
    first = X[rng.randint(k0, (), 0, m, dev)]
    pool = torch.zeros((1 + l * rounds, n), dtype=torch.float32, device=dev)
    pool[0] = first
    d = ref.min_update_ref(torch.full((m,), float("inf"), device=dev), X,
                           first)
    for r in range(rounds):
        key, kr = rng.split(key)
        idx = rng.categorical(kr, d2_logits(d), l, dev)
        newpts = X[idx]                              # [l, n]
        pool[1 + r * l:1 + (r + 1) * l] = newpts
        dc = ref.pairwise_sqdist_ref(X, newpts)      # [m, l]
        d = torch.minimum(d, torch.min(dc, dim=1).values)
        del dc                  # not held beside the next round's [m, l]

    # Weight pool members by the number of points closest to them, then
    # recluster the weighted pool down to k with K-means++ and Lloyd.
    ids, _ = ops.assign(X, pool, impl=impl)
    _, w = ops.update(X, ids, pool.shape[0], impl=impl)
    key, k1 = rng.split(key)
    c0 = kmeanspp(pool, k1, k, weights=w, impl=impl, rng=rng)
    pooled = kmeans.lloyd(pool, c0, weights=w, max_iters=max_iters, tol=tol,
                          impl=impl)
    # Final Lloyd on the full dataset from the K-means|| seeds.
    return kmeans.lloyd(X, pooled.centroids, max_iters=max_iters, tol=tol,
                        impl=impl)
