"""The numbers that decide ``correct``, each worked out again in float64
from the benchmark's own inputs.

* :func:`judge_evaluate` — a full-data assignment (``evaluate``'s ids and
  objective) against the exact one: ``ids_gap``, the widest amount by which
  a row's chosen centroid lies farther than its nearest, over the mean
  distance of a row; ``f_eval_rel``, the objective's relative error.
* :func:`judge_fit` — a fit's incumbent logic and its centroids.
  ``accept_violations``: the chunks of the fit's trace whose accept or
  reject breaks Big-means' rule (a chunk is kept iff its objective is
  strictly below the incumbent's, which starts at infinity), chunks out of
  order, and a returned objective other than the rule's incumbent's.  On
  the chunk that the rule makes the winner, its rows drawn again from the
  job's seed with the sampler's key tree (:mod:`perfbench.gen.rng`):
  ``f_chunk_rel``, the reported objective's relative error there, and
  ``lloyd_residual``, what one more exact Lloyd update would still take
  off the chunk's objective, over the objective (``sum_j count_j *
  ||c_j - mean_j||^2 / f``): near 0 at a Lloyd fixed point, large for
  centroids that were not moved to their means, or that are another
  chunk's.
* :func:`denominator_rel` — the benchmark's own objective of the true
  component means, against this module's.
"""
from __future__ import annotations

import math

import torch

from perfbench.gen import rng

BLOCK_ELEMS = 1 << 27     # elements of a block's float64 distance matrix


def _block_rows(k: int, n: int) -> int:
    return max(1, BLOCK_ELEMS // max(k, n))


def _dist64(x: torch.Tensor, c64: torch.Tensor, c2: torch.Tensor):
    x = x.double()
    d = (x * x).sum(1, keepdim=True) - 2.0 * (x @ c64.T) + c2[None, :]
    return d.clamp_min_(0.0)


def judge_evaluate(X: torch.Tensor, C: torch.Tensor, ids, f) -> dict:
    """``ids_gap`` and ``f_eval_rel`` of a full-data assignment."""
    m, n = X.shape
    k = C.shape[0]
    ids = torch.as_tensor(ids)
    f = float(f)
    if ids.shape != (m,) or ids.dtype.is_floating_point \
            or not math.isfinite(f) or int(ids.min()) < 0 \
            or int(ids.max()) >= k:
        return {"ids_gap": math.inf, "f_eval_rel": math.inf}
    c64 = C.to(X.device).double()
    c2 = (c64 * c64).sum(1)
    ids = ids.to(X.device).long()
    total = 0.0
    gap = 0.0
    step = _block_rows(k, n)
    for lo in range(0, m, step):
        d = _dist64(X[lo:lo + step], c64, c2)
        dmin = d.min(1).values
        chosen = d.gather(1, ids[lo:lo + step, None])[:, 0]
        total += float(dmin.sum())
        gap = max(gap, float((chosen - dmin).max()))
    scale = total / m
    return {"ids_gap": gap / scale if scale > 0 else math.inf,
            "f_eval_rel": abs(f - total) / total}


def chunk_rows(job_seed: int, chunk: int, *, m: int, s: int, n_chunks: int,
               device) -> torch.Tensor:
    """Row indices of chunk ``chunk`` of a sequential fit seeded
    ``job_seed``: the key tree's ``split(key(seed), n_chunks)[chunk]``,
    its first child, ``s`` uniform draws of ``[0, m)``."""
    key_i = rng.split(rng.key(job_seed), n_chunks)[chunk]
    ks, _ = rng.split(key_i)
    return rng.randint(ks, (s,), 0, m, device)


def accept_rule(trace, objective, n_chunks: int) -> tuple[int | None, int]:
    """(the chunk that Big-means' rule makes the winner, the number of
    violations of the rule) of a sequential fit's ``(chunk, f_new,
    accepted)`` trace and its returned objective.  Entries of other shapes
    (the program's events) are left out; a missing or extra chunk, or one
    out of order, is a violation."""
    chunks = [t for t in trace if isinstance(t, (tuple, list)) and len(t) == 3
              and isinstance(t[0], int) and not isinstance(t[0], bool)]
    bad = int([int(t[0]) for t in chunks] != list(range(n_chunks)))
    best, winner = math.inf, None
    for i, f_new, accepted in chunks:
        keep = float(f_new) < best
        bad += bool(accepted) != keep
        if keep:
            best, winner = float(f_new), int(i)
    bad += float(objective) != best
    return winner, bad


def judge_fit(X: torch.Tensor, C: torch.Tensor, objective, trace, *,
              job_seed: int, s: int, n_chunks: int) -> dict:
    """``accept_violations``, ``f_chunk_rel`` and ``lloyd_residual`` of
    a fit."""
    chunk, violations = accept_rule(trace, objective, n_chunks)
    bad = {"accept_violations": float(violations), "f_chunk_rel": math.inf,
           "lloyd_residual": math.inf}
    C = torch.as_tensor(C)
    if chunk is None or not bool(torch.isfinite(C).all()):
        return bad
    idx = chunk_rows(job_seed, chunk, m=X.shape[0], s=s, n_chunks=n_chunks,
                     device=X.device)
    P = X.index_select(0, idx).double()
    c64 = C.to(X.device).double()
    k, n = c64.shape
    c2 = (c64 * c64).sum(1)
    dmin, ids = [], []
    step = _block_rows(k, n)
    for lo in range(0, s, step):
        d = _dist64(P[lo:lo + step], c64, c2)
        v, i = d.min(1)
        dmin.append(v)
        ids.append(i)
    dmin, ids = torch.cat(dmin), torch.cat(ids)
    f64 = float(dmin.sum())
    counts = torch.bincount(ids, minlength=k).double()
    sums = torch.zeros_like(c64).index_add_(0, ids, P)
    held = counts > 0
    means = sums[held] / counts[held, None]
    residual = float((counts[held] * ((c64[held] - means) ** 2).sum(1)).sum())
    return {"accept_violations": float(violations),
            "f_chunk_rel": abs(float(objective) - f64) / f64,
            "lloyd_residual": residual / f64}


def true_objective64(X: torch.Tensor, means: torch.Tensor) -> float:
    """f(M, X) in float64, by direct differences (the benchmark's own
    figure is taken by the expanded form; the two orders differ)."""
    m, n = X.shape
    k = means.shape[0]
    mu = means.to(X.device).double()
    step = max(1, BLOCK_ELEMS // (k * n))
    total = 0.0
    for lo in range(0, m, step):
        x = X[lo:lo + step].double()
        d = ((x[:, None, :] - mu[None, :, :]) ** 2).sum(2)
        total += float(d.min(1).values.sum())
    return total


def denominator_rel(X: torch.Tensor, means: torch.Tensor,
                    f_true: float) -> dict:
    ref = true_objective64(X, means)
    return {"denominator_rel": abs(float(f_true) - ref) / ref}
