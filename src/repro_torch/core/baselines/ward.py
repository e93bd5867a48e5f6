"""Ward's agglomerative clustering (paper §5.5) — nearest-neighbor chain.

Deterministic, O(m^2) memory / ~O(m^2) time via the NN-chain algorithm with
the Lance-Williams update for Ward's criterion.  As in the paper, this is a
small/medium-data baseline only (it exhausts RAM on big data — that failure
mode is part of the paper's point and is reproduced by the m^2 matrix).
Implemented in NumPy float64 on the host, a copy of the reference's
module: hierarchical merging is inherently sequential/dynamic, and no
kernel exists for it.  Its labels and centroids are the reference's, bit
for bit, on the same input.
"""
from __future__ import annotations

import numpy as np


def ward(X, k: int):
    """Cluster rows of X into k clusters.  Returns (centroids [k,n], labels [m])."""
    X = np.asarray(X, dtype=np.float64)
    m, n = X.shape
    if m > 20000:
        raise MemoryError(
            f"Ward's method needs an O(m^2) distance matrix; m={m} is 'big "
            "data' by the paper's definition and intentionally unsupported."
        )
    # Ward distance between singletons is ||a-b||^2 / 2 * (1*1/(1+1)) — any
    # monotone scaling works; use d = ||a-b||^2 * (na*nb)/(na+nb).
    sq = np.sum(X * X, axis=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    np.maximum(d, 0.0, out=d)
    d *= 0.5                                                 # na=nb=1
    np.fill_diagonal(d, np.inf)

    size = np.ones(m)
    active = np.ones(m, dtype=bool)
    parent = np.arange(m)
    n_active = m
    chain: list[int] = []

    while n_active > k:
        if not chain:
            chain.append(int(np.argmax(active)))
        while True:
            a = chain[-1]
            row = d[a].copy()
            row[~active] = np.inf
            row[a] = np.inf
            b = int(np.argmin(row))
            if len(chain) > 1 and b == chain[-2]:
                break                                        # reciprocal pair
            chain.append(b)
        b = chain.pop()
        a = chain.pop()
        # Lance-Williams (Ward): d(ab, c)
        na, nb, nc = size[a], size[b], size
        dab = d[a, b]
        new = ((na + nc) * d[a] + (nb + nc) * d[b] - nc * dab) / (na + nb + nc)
        d[a, :] = new
        d[:, a] = new
        d[a, a] = np.inf
        active[b] = False
        d[b, :] = np.inf
        d[:, b] = np.inf
        size[a] = na + nb
        parent[parent == b] = a
        n_active -= 1

    # Labels: compress the union roots into [0, k).
    roots = np.flatnonzero(active)
    lut = {int(r): i for i, r in enumerate(roots)}
    # parent holds direct merge targets; resolve transitively.
    lab = parent.copy()
    for _ in range(m):  # bounded; usually converges in a few passes
        nxt = parent[lab]
        if np.array_equal(nxt, lab):
            break
        lab = nxt
    labels = np.array([lut[int(r)] for r in lab])
    centroids = np.stack([X[labels == i].mean(axis=0) for i in range(k)])
    return centroids.astype(np.float32), labels.astype(np.int32)
