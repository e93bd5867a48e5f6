"""Big-means (Algorithm 3): the chunk step and its state.

:func:`chunk_step` re-seeds degenerate slots with K-means++, runs Lloyd and
keeps the better of the new solution and the incumbent, with the
reference's accept rule (a strict ``<`` on the chunk objective) and its
analytic distance-evaluation counter ``n_d``.  :func:`sample_chunk` is the
uniform decomposition sampler.  :func:`chunk_step_batched` is the same step
for B incumbent streams at once, with the state algebra of the batched
driver (:func:`broadcast_state`, :func:`reduce_state`,
:func:`_sync_streams`).  :func:`big_means_sharded` runs one chunk stream
per worker of a device mesh, exchanging incumbents every ``sync_every``
chunks (:func:`_exchange_best`).  The chunk loops live in
:mod:`repro_torch.engine.incore`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import tracing
from repro_torch.core import kmeans, kmeanspp


class BigMeansState(NamedTuple):
    """One incumbent; batched states carry a leading [B] axis on every
    field."""
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
    # three scalars copied from the host, each copy waited for
    tracing.count("host_sync.core.bigmeans.init", 3)
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
    with tracing.span("core.bigmeans.chunk_step", points):
        k = state.centroids.shape[0]
        s = points.shape[0]

        # line 7: re-initialize degenerate centroids with K-means++ on this
        # chunk; the identity when no slot is degenerate.
        n_deg = int(torch.sum(state.degenerate))
        tracing.count("host_sync.core.bigmeans.degenerate")
        if n_deg:
            c_init = kmeanspp.seed(points, key, k, init=state.centroids,
                                   degenerate=state.degenerate,
                                   candidates=candidates, impl=impl, rng=rng)
        else:
            c_init = state.centroids.float()
        # line 8: local search
        res = kmeans.lloyd(points, c_init, max_iters=max_iters, tol=tol,
                           impl=impl, precision=precision)

        # lines 9-11: keep the best (objectives of equal-size chunks compared)
        accepted = res.objective < state.f_best
        n_d = state.n_dist_evals + float(
            _n_dist_evals(k, s, candidates, res.iterations, n_deg))
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
    with tracing.span("core.bigmeans.sample_chunk", X):
        if with_replacement:
            idx = rng.randint(key, (s,), 0, m, X.device)
        else:
            idx = rng.choice(key, m, s, X.device)
        return X.index_select(0, idx.to(device=X.device, dtype=torch.int64))


def _n_dist_evals(k: int, s: int, candidates: int, iterations, n_deg):
    """The paper's n_d increment in float32, in the reference's order of
    operations (bigmeans.py:102-106): s * (k * (iters + 2) + candidates *
    n_deg).  Scalars or [B] arrays of equal shape."""
    per_point = (np.float32(k) * np.float32(iterations + 2)
                 + np.float32(candidates) * np.float32(n_deg))
    return np.float32(s) * per_point


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


# ---------------------------------------------------------------------------
# B incumbent streams on one device (the reference's batched driver)
# ---------------------------------------------------------------------------


def broadcast_state(state: BigMeansState, batch: int) -> BigMeansState:
    """Tile one incumbent into B streams; the stream counters start at zero
    so :func:`reduce_state` can re-aggregate them onto a base state."""
    zeroed = state._replace(n_accepted=torch.zeros_like(state.n_accepted),
                            n_dist_evals=torch.zeros_like(state.n_dist_evals))
    return BigMeansState(*(a.expand((batch,) + a.shape).clone()
                           for a in zeroed))


def reduce_state(states: BigMeansState,
                 base: BigMeansState | None = None) -> BigMeansState:
    """Argmin-reduce B streams into one incumbent (the first stream wins a
    tie), degenerate mask included.  Counters are summed across streams —
    they count work done, not who won — and added onto ``base`` when
    given."""
    winner = torch.argmin(states.f_best)
    tracing.count("host_sync.core.bigmeans.winner", 3)    # a[winner] reads it
    n_acc = torch.sum(states.n_accepted).to(torch.int32)
    n_d = torch.sum(states.n_dist_evals)
    if base is not None:
        n_acc = n_acc + base.n_accepted
        n_d = n_d + base.n_dist_evals
    return BigMeansState(
        centroids=states.centroids[winner],
        degenerate=states.degenerate[winner],
        f_best=states.f_best[winner],
        n_accepted=n_acc,
        n_dist_evals=n_d,
    )


def _sync_streams(states: BigMeansState) -> BigMeansState:
    """Give every stream the winner's incumbent (the first stream wins a
    tie); counters stay per stream."""
    winner = torch.argmin(states.f_best)
    tracing.count("host_sync.core.bigmeans.winner", 3)    # a[winner] reads it
    batch = states.f_best.shape[0]

    def tile(a):
        return a[winner].expand((batch,) + a.shape[1:]).clone()

    return states._replace(centroids=tile(states.centroids),
                           degenerate=tile(states.degenerate),
                           f_best=tile(states.f_best))


def chunk_step_batched(
    points: torch.Tensor,
    states: BigMeansState,
    keys,
    *,
    max_iters: int = 300,
    tol: float = 1e-4,
    candidates: int = 3,
    impl: str = "auto",
    precision: str = "auto",
    rng=rnd.TORCH,
) -> tuple[BigMeansState, ChunkInfo]:
    """B chunks against B incumbent streams: points [B, s, n], states with
    a leading batch axis, one key per stream.

    Per stream this is exactly :func:`chunk_step` (re-seed degenerate
    slots, Lloyd, keep-the-best, n_d); Lloyd advances all streams at once
    (:func:`kmeans.lloyd_batched`, one kernel-D launch per iteration).
    """
    with tracing.span("core.bigmeans.chunk_step", points):
        k = states.centroids.shape[1]
        s = points.shape[1]
        n_deg = torch.sum(states.degenerate, dim=1).cpu().numpy()    # [B]
        tracing.count("host_sync.core.bigmeans.batched")
        # seeding is skipped when no stream has a degenerate slot
        if n_deg.any():
            c_init = kmeanspp.seed_batched(
                points, keys, k, init=states.centroids,
                degenerate=states.degenerate, candidates=candidates,
                impl=impl, rng=rng)
        else:
            c_init = states.centroids.float()
        res = kmeans.lloyd_batched(points, c_init, max_iters=max_iters,
                                   tol=tol, impl=impl, precision=precision)

        accepted = res.objective < states.f_best                    # [B]
        n_d = _n_dist_evals(k, s, candidates, res.iterations.cpu().numpy(),
                            n_deg)
        # the read of the iterations and the copy of n_d back, waited for
        tracing.count("host_sync.core.bigmeans.batched", 2)
        new_states = BigMeansState(
            centroids=torch.where(accepted[:, None, None], res.centroids,
                                  states.centroids),
            degenerate=torch.where(accepted[:, None], res.degenerate,
                                   states.degenerate),
            f_best=torch.where(accepted, res.objective, states.f_best),
            n_accepted=states.n_accepted + accepted.to(torch.int32),
            n_dist_evals=states.n_dist_evals + torch.from_numpy(n_d).to(
                states.n_dist_evals.device),
        )
        info = ChunkInfo(
            f_new=res.objective,
            accepted=accepted,
            lloyd_iters=res.iterations,
            n_degenerate=torch.sum(res.degenerate, dim=1),
        )
        return new_states, info


def big_means_batched(
    X,
    key,
    *,
    k: int,
    s: int,
    batch: int,
    rounds: int,
    sync_every: int = 1,
    max_iters: int = 300,
    tol: float = 1e-4,
    candidates: int = 3,
    impl: str = "auto",
    with_replacement: bool = True,
    precision: str = "auto",
    rng=rnd.TORCH,
    device=None,
    mesh=None,
    stream_axis: str = "streams",
) -> tuple[BigMeansState, ChunkInfo]:
    """Batched Big-means: B incumbent streams over ``rounds`` chunk rounds,
    exchanging incumbents every ``sync_every`` rounds.  Returns the reduced
    incumbent and a round-major ``[rounds * batch]`` trace.  ``batch=1`` is
    the sequential :func:`big_means` with ``n_chunks=rounds``: the same key
    schedule, and in this package the same result bit for bit.

    Runs on the CUDA device unless ``device="cpu"``
    (:func:`repro_torch.engine.incore.batched_local`).  With ``mesh`` (a
    :class:`repro_torch.engine.topology.DeviceMesh` with a ``stream_axis``
    of D positions) the B streams are split into D groups of B / D, each
    advanced on its mesh device, and the periodic exchange is an argmin
    over all streams (:func:`repro_torch.engine.incore.batched_stream_mesh`):
    the same key schedule and, stream by stream, the same steps as on one
    device.  The trace is then group-major, as the reference's is.
    """
    from repro_torch.engine import incore

    if rounds % sync_every:
        raise ValueError(
            f"sync_every ({sync_every}) must divide rounds ({rounds})")
    kwargs = dict(
        k=k, s=s, batch=batch, rounds=rounds, sync_every=sync_every,
        max_iters=max_iters, tol=tol, candidates=candidates, impl=impl,
        with_replacement=with_replacement, precision=precision, rng=rng)
    if mesh is not None:
        return incore.batched_stream_mesh(
            X, key, mesh=mesh, stream_axis=stream_axis, **kwargs)
    return incore.batched_local(X, key, device=device, **kwargs)


# ---------------------------------------------------------------------------
# one chunk stream per worker (the reference's sharded strategy)
# ---------------------------------------------------------------------------


def _exchange_best(states: list) -> list:
    """Keep-the-best across workers: the argmin of the workers' ``f_best``
    (the first worker wins a tie, as ``jnp.argmin`` picks), read on the
    host; every worker continues from the winner's centroids, degenerate
    mask and ``f_best``, on its own device.  Counters stay per worker."""
    f_all = torch.stack([st.f_best.detach().cpu() for st in states])
    w = states[int(torch.argmin(f_all))]
    return [st._replace(centroids=w.centroids.to(st.centroids.device),
                        degenerate=w.degenerate.to(st.degenerate.device),
                        f_best=w.f_best.to(st.f_best.device))
            for st in states]


def big_means_sharded(
    X,
    key,
    *,
    mesh,
    k: int,
    s: int,
    chunks_per_worker: int,
    sync_every: int = 1,
    axes: tuple = ("data",),
    max_iters: int = 300,
    tol: float = 1e-4,
    candidates: int = 3,
    impl: str = "auto",
    with_replacement: bool = True,
    precision: str = "auto",
    rng=rnd.TORCH,
) -> tuple[BigMeansState, ChunkInfo]:
    """Multi-worker Big-means: X row-sharded over the ``axes`` of ``mesh``
    (a :class:`repro_torch.engine.topology.DeviceMesh`); one chunk stream
    per worker, with an incumbent exchange every ``sync_every`` chunks.

    Each worker samples chunks from its own contiguous row shard (uniform
    placement makes local sampling equivalent to global sampling) with the
    key ``fold_in(key, worker_index)``, so results are reproducible for a
    fixed topology.  Workers run in worker order, each on its mesh device
    (:func:`repro_torch.engine.incore.worker_sharded`).  Returns the
    incumbent (counters summed over the workers) and the worker-major
    trace of every worker's chunks.
    """
    from repro_torch.engine import incore

    return incore.worker_sharded(
        X, key, mesh=mesh, k=k, s=s, chunks_per_worker=chunks_per_worker,
        sync_every=sync_every, axes=axes, max_iters=max_iters, tol=tol,
        candidates=candidates, impl=impl, with_replacement=with_replacement,
        precision=precision, rng=rng)
