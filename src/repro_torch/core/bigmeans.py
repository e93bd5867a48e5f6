"""Big-means (Algorithm 3): the chunk step and its state.

:func:`chunk_step` re-seeds degenerate slots with K-means++, runs Lloyd and
keeps the better of the new solution and the incumbent, with the
reference's accept rule (a strict ``<`` on the chunk objective) and its
analytic distance-evaluation counter ``n_d``.  :func:`sample_chunk` is the
uniform decomposition sampler.  The chunk loop lives in
:mod:`repro_torch.engine.incore`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import kmeans, kmeanspp


class BigMeansState(NamedTuple):
    centroids: torch.Tensor     # [k, n] f32 — incumbent C
    degenerate: torch.Tensor    # [k] bool — degeneracy mask of the incumbent
    f_best: torch.Tensor        # 0-d f32 — f(C, P_C) on its chunk
    n_accepted: torch.Tensor    # 0-d int32
    n_dist_evals: torch.Tensor  # 0-d f32 — the paper's n_d counter


class ChunkInfo(NamedTuple):
    f_new: torch.Tensor         # f32: f of this chunk's Lloyd solution
    accepted: torch.Tensor      # bool
    lloyd_iters: torch.Tensor   # int32
    n_degenerate: torch.Tensor  # int: empty clusters of the new solution


def init_state(k: int, n: int, *, device) -> BigMeansState:
    return BigMeansState(
        centroids=torch.zeros((k, n), dtype=torch.float32, device=device),
        degenerate=torch.ones((k,), dtype=torch.bool, device=device),
        f_best=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        n_accepted=torch.tensor(0, dtype=torch.int32, device=device),
        n_dist_evals=torch.tensor(0.0, dtype=torch.float32, device=device),
    )


def chunk_step(
    points: torch.Tensor,
    state: BigMeansState,
    key,
    *,
    max_iters: int = 300,
    tol: float = 1e-4,
    candidates: int = 3,
    impl: str = "auto",
    precision: str = "auto",
    rng=rnd.TORCH,
) -> tuple[BigMeansState, ChunkInfo]:
    """Process one chunk P (Algorithm 3, lines 5-12)."""
    k = state.centroids.shape[0]
    s = points.shape[0]

    # line 7: re-initialize degenerate centroids with K-means++ on this
    # chunk; the identity when no slot is degenerate.
    n_deg = int(torch.sum(state.degenerate))
    if n_deg:
        c_init = kmeanspp.seed(points, key, k, init=state.centroids,
                               degenerate=state.degenerate,
                               candidates=candidates, rng=rng)
    else:
        c_init = state.centroids.float()
    # line 8: local search
    res = kmeans.lloyd(points, c_init, max_iters=max_iters, tol=tol,
                       impl=impl, precision=precision)

    # lines 9-11: keep the best (objectives of equal-size chunks compared)
    accepted = res.objective < state.f_best
    # n_d in float32, in the reference's order of operations
    # (bigmeans.py:102-106): s * (k * (iters + 2) + candidates * n_deg).
    per_point = (np.float32(k) * np.float32(res.iterations + 2)
                 + np.float32(candidates) * np.float32(n_deg))
    n_d = state.n_dist_evals + float(np.float32(s) * per_point)
    new_state = BigMeansState(
        centroids=torch.where(accepted, res.centroids, state.centroids),
        degenerate=torch.where(accepted, res.degenerate, state.degenerate),
        f_best=torch.where(accepted, res.objective, state.f_best),
        n_accepted=state.n_accepted + accepted.to(torch.int32),
        n_dist_evals=n_d,
    )
    info = ChunkInfo(
        f_new=res.objective,
        accepted=accepted,
        lloyd_iters=torch.tensor(res.iterations, dtype=torch.int32),
        n_degenerate=torch.sum(res.degenerate),
    )
    return new_state, info


def sample_chunk(X: torch.Tensor, key, s: int, *,
                 with_replacement: bool = True,
                 rng=rnd.TORCH) -> torch.Tensor:
    """Uniform random chunk of s rows (the paper's decomposition sampler)."""
    m = X.shape[0]
    if with_replacement:
        idx = rng.randint(key, (s,), 0, m, X.device)
    else:
        idx = rng.choice(key, m, s, X.device)
    return X.index_select(0, idx.to(device=X.device, dtype=torch.int64))


def big_means(
    X,
    key,
    *,
    k: int,
    s: int,
    n_chunks: int,
    max_iters: int = 300,
    tol: float = 1e-4,
    candidates: int = 3,
    impl: str = "auto",
    with_replacement: bool = True,
    precision: str = "auto",
    rng=rnd.TORCH,
    device=None,
) -> tuple[BigMeansState, ChunkInfo]:
    """Sequential Big-means over an in-core dataset.  Returns (state, traces).

    Runs on the CUDA device unless ``device="cpu"``
    (:func:`repro_torch.engine.incore.sequential`).
    """
    from repro_torch.engine import incore

    return incore.sequential(
        X, key, k=k, s=s, n_chunks=n_chunks, max_iters=max_iters, tol=tol,
        candidates=candidates, impl=impl, with_replacement=with_replacement,
        precision=precision, rng=rng, device=device)
