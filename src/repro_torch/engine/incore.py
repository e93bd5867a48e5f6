"""In-core execution: the chunk loops of the single-device drivers.

:func:`sequential` is the paper's Algorithm 3.  The reference scans a
jitted body over ``split(key, n_chunks)``; here the scan is a Python loop
over the same key tree: chunk ``i`` gets ``split(key, n_chunks)[i]``, split
again into ``(ks, kc)`` — ``ks`` samples the chunk, ``kc`` drives K-means++
re-seeding.

:func:`batched_local` runs B incumbent streams on one device (uniform
schedule, periodic sync): chunk (r, b) of round r and stream b gets
``split(key, rounds * batch)[r * batch + b]`` (:func:`stream_keys`), so
``batch=1`` is the sequential schedule; every ``sync_every`` rounds the
streams exchange incumbents.  :func:`batched_stream_mesh` is the same run
with the B streams split into D groups over a stream mesh, each group
advanced on its device.

:func:`worker_sharded` runs one chunk stream per worker of a worker mesh,
each on a contiguous row shard of X with the key ``fold_in(key,
worker_index)``: window ``r`` gives worker ``w`` the chunk keys
``split(split(fold_in(key, w), n_rounds)[r], sync_every)``, and after
every window the workers exchange incumbents (an argmin over their
``f_best``).  The reference runs the workers at once under ``shard_map``;
here they run one after another in worker order, each on its mesh
device, window by window (:func:`_sharded_segment`).
:func:`worker_sharded_rounds` drives those windows with the middleware
stack between them (checkpoint / resume, the time budget).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core.bigmeans import (
    BigMeansState, ChunkInfo, _exchange_best, _sync_streams, broadcast_state,
    chunk_step, chunk_step_batched, init_state, reduce_state, sample_chunk,
)
from repro_torch.engine import middleware as mw
from repro_torch.engine import topology as topo_lib
from repro_torch.kernels import precision as px


def _cast_dataset(X, precision, device: torch.device) -> torch.Tensor:
    """The dataset in its storage on ``device`` (reference
    ``engine/incore.py:49-59``): bf16 under ``'bf16'`` (half the device
    memory; ``'auto'`` on a bf16 tensor is ``'bf16'``), f32 otherwise.

    int8 keeps the dataset full-width: scales are a property of the chunk
    (``s[f]`` over its points), so each sampled chunk is quantized at Lloyd
    entry — one scale row per stream in the batched loop.
    """
    prec = px.resolve(precision, devices.data_dtype(X))
    dtype = torch.float32 if prec == "int8" else px.storage_dtype(prec)
    return devices.to_dtype(X, device, dtype)


def sequential(
    X, key, *, k: int, s: int, n_chunks: int, max_iters: int = 300,
    tol: float = 1e-4, candidates: int = 3, impl: str = "auto",
    with_replacement: bool = True, precision: str = "auto",
    rng=rnd.TORCH, device=None,
) -> tuple[BigMeansState, ChunkInfo]:
    """Sequential Big-means over an in-core dataset.  Returns (state, traces)
    with one entry per chunk in every field of the traces."""
    dev = devices.resolve(device)
    X = _cast_dataset(X, precision, dev)
    state = init_state(k, X.shape[1], device=dev)
    infos = []
    for key_i in rng.split(key, n_chunks):
        ks, kc = rng.split(key_i)
        chunk = sample_chunk(X, ks, s, with_replacement=with_replacement,
                             rng=rng)
        state, info = chunk_step(
            chunk, state, kc, max_iters=max_iters, tol=tol,
            candidates=candidates, impl=impl, precision=precision, rng=rng)
        infos.append(info)
    traces = ChunkInfo(*(torch.stack(list(field)) for field in zip(*infos)))
    return state, traces


def stream_keys(key, rounds: int, sync_every: int, batch: int, *,
                rng=rnd.TORCH) -> list:
    """Nested ``[rounds // sync_every][sync_every][batch]`` key schedule:
    chunk (r, b) gets ``split(key, rounds * batch)[r * batch + b]`` — for
    batch=1 the sequential schedule."""
    keys = rng.split(key, rounds * batch)
    rows = [keys[r * batch:(r + 1) * batch] for r in range(rounds)]
    return [rows[o:o + sync_every] for o in range(0, rounds, sync_every)]


def stream_scan(X, states: BigMeansState, keys, *, s: int, max_iters: int,
                tol: float, candidates: int, impl: str,
                with_replacement: bool, sync_fn, precision: str = "auto",
                rng=rnd.TORCH) -> tuple[BigMeansState, ChunkInfo]:
    """Run the chunk rounds of ``keys`` (:func:`stream_keys`) over
    per-stream states; ``sync_fn`` exchanges incumbents at each sync
    boundary.  The traces are round-major, ``[rounds * batch]``."""
    infos = []
    for keys_outer in keys:
        for keys_r in keys_outer:                   # one key per stream
            split = [rng.split(key_b) for key_b in keys_r]
            chunks = torch.stack([
                sample_chunk(X, ks, s, with_replacement=with_replacement,
                             rng=rng) for ks, _ in split])
            states, info = chunk_step_batched(
                chunks, states, [kc for _, kc in split], max_iters=max_iters,
                tol=tol, candidates=candidates, impl=impl,
                precision=precision, rng=rng)
            infos.append(info)
        states = sync_fn(states)
    traces = ChunkInfo(*(torch.cat(list(field)) for field in zip(*infos)))
    return states, traces


def batched_local(
    X, key, *, k: int, s: int, batch: int, rounds: int, sync_every: int,
    max_iters: int = 300, tol: float = 1e-4, candidates: int = 3,
    impl: str = "auto", with_replacement: bool = True,
    precision: str = "auto", rng=rnd.TORCH, device=None,
) -> tuple[BigMeansState, ChunkInfo]:
    """Batched Big-means on one device.  Returns the argmin-reduced state
    (counters summed over streams) and round-major traces."""
    dev = devices.resolve(device)
    X = _cast_dataset(X, precision, dev)
    states = broadcast_state(init_state(k, X.shape[1], device=dev), batch)
    keys = stream_keys(key, rounds, sync_every, batch, rng=rng)
    states, infos = stream_scan(
        X, states, keys, s=s, max_iters=max_iters, tol=tol,
        candidates=candidates, impl=impl, with_replacement=with_replacement,
        sync_fn=_sync_streams, precision=precision, rng=rng)
    return reduce_state(states), infos


def _cat_infos(infos, device) -> ChunkInfo:
    """Concatenate ChunkInfos of [*] fields (each field on its own device)
    into one ChunkInfo on ``device``; none gives empty fields."""
    if not infos:
        return ChunkInfo(
            f_new=torch.zeros(0, dtype=torch.float32, device=device),
            accepted=torch.zeros(0, dtype=torch.bool, device=device),
            lloyd_iters=torch.zeros(0, dtype=torch.int32, device=device),
            n_degenerate=torch.zeros(0, dtype=torch.int64, device=device))
    return ChunkInfo(*(torch.cat([f.reshape(-1).to(device) for f in field])
                       for field in zip(*infos)))


def batched_stream_mesh(
    X, key, *, mesh, stream_axis: str, k: int, s: int, batch: int,
    rounds: int, sync_every: int, max_iters: int = 300, tol: float = 1e-4,
    candidates: int = 3, impl: str = "auto", with_replacement: bool = True,
    precision: str = "auto", rng=rnd.TORCH,
) -> tuple[BigMeansState, ChunkInfo]:
    """Batched Big-means with the B streams split into D groups over the
    ``stream_axis`` of ``mesh``: group g holds streams ``g*B/D ..
    (g+1)*B/D - 1`` and advances them on its mesh device with
    :func:`stream_scan`, under the key schedule of :func:`batched_local`.
    Every ``sync_every`` rounds every stream continues from the winner over
    all streams (the first wins a tie, as the reference's argmin over the
    groups' winners picks).  The final state is that winner's, with the
    counters summed group by group, and the trace is group-major (each
    group's round-major trace in turn), as the reference's ``shard_map``
    lays it out."""
    topo = topo_lib.StreamMesh(mesh, stream_axis)
    groups = topo.devices
    if batch % groups:
        raise ValueError(
            f"the stream mesh's {groups} groups must divide batch ({batch})")
    bl = batch // groups
    group_devs = topo.group_devices()
    xd = _cast_dataset(X, precision, group_devs[0])
    xs = [xd.to(dev) for dev in group_devs]
    states = [broadcast_state(init_state(k, xd.shape[1], device=dev), bl)
              for dev in group_devs]
    infos: list = [[] for _ in group_devs]
    kwargs = dict(s=s, max_iters=max_iters, tol=tol, candidates=candidates,
                  impl=impl, with_replacement=with_replacement,
                  precision=precision, rng=rng)
    for keys_outer in stream_keys(key, rounds, sync_every, batch, rng=rng):
        for g in range(groups):
            keys_g = [[row[g * bl:(g + 1) * bl] for row in keys_outer]]
            states[g], info = stream_scan(
                xs[g], states[g], keys_g, sync_fn=lambda st: st, **kwargs)
            infos[g].append(info)
        w = _mesh_winner(states)
        states = [st._replace(**{f: w[f].to(st.f_best.device).expand(
            (bl,) + w[f].shape).clone() for f in
            ("centroids", "degenerate", "f_best")}) for st in states]
    dev0 = group_devs[0]
    w = _mesh_winner(states)
    final = BigMeansState(
        centroids=w["centroids"].to(dev0),
        degenerate=w["degenerate"].to(dev0), f_best=w["f_best"].to(dev0),
        n_accepted=torch.sum(torch.stack(
            [torch.sum(st.n_accepted).to(dev0) for st in states])
        ).to(torch.int32),
        n_dist_evals=torch.sum(torch.stack(
            [torch.sum(st.n_dist_evals).to(dev0) for st in states])))
    return final, _cat_infos([i for group in infos for i in group], dev0)


def _mesh_winner(states: list) -> dict:
    """The incumbent of the first stream with the least ``f_best`` over
    the groups' streams (read on the host), as {field: tensor}."""
    f_all = torch.cat([st.f_best.detach().cpu() for st in states])
    w = int(torch.argmin(f_all))
    bl = states[0].f_best.shape[0]
    st = states[w // bl]
    return {f: getattr(st, f)[w % bl]
            for f in ("centroids", "degenerate", "f_best")}


# ---------------------------------------------------------------------------
# worker mesh: one chunk stream per worker, argmin exchange every window
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundsMetrics:
    """What the rounds loop's middleware reads and writes: trace events
    (``("ckpt_fallback", step)``) and the checkpoint times."""
    trace: list = dataclasses.field(default_factory=list)
    checkpoint: dict = dataclasses.field(default_factory=lambda: {
        "save_ms": [], "restore_ms": []})


def _worker_shards(xd: torch.Tensor, worker_devs: list) -> list:
    """Contiguous row shards of X, one per worker (views when the worker's
    device holds X)."""
    W, m = len(worker_devs), xd.shape[0]
    if m % W:
        raise ValueError(
            f"the worker count ({W}) must divide the rows of X ({m}): each "
            "worker takes an equal contiguous row shard")
    rows = m // W
    return [xd[w * rows:(w + 1) * rows].to(dev)
            for w, dev in enumerate(worker_devs)]


def _stack_states(states: list, device) -> BigMeansState:
    """Per-worker states as one state with a leading [W] axis (the
    reference's state stack, which the checkpoints store)."""
    return BigMeansState(*(torch.stack([f.to(device) for f in field])
                           for field in zip(*states)))


def _sharded_segment(
    shards: list, worker_keys: list, r: int, states: list, *, s: int,
    n_rounds: int, sync_every: int, max_iters: int, tol: float,
    candidates: int, impl: str, with_replacement: bool, precision: str,
    rng,
) -> tuple[list, list]:
    """Window ``r`` of the worker-sharded run: ``sync_every`` chunks per
    worker, in worker order, then the argmin exchange.  Worker ``w``'s
    window key is ``split(worker_keys[w], n_rounds)[r]``, so an
    uninterrupted sequence of windows is :func:`worker_sharded`'s run.
    Returns the per-worker states after the exchange and each worker's
    ChunkInfo of the window (``[sync_every]`` fields)."""
    new_states, infos = [], []
    for x_local, kw, state in zip(shards, worker_keys, states):
        key_r = rng.split(kw, n_rounds)[r]
        chunk_infos = []
        for key_i in rng.split(key_r, sync_every):
            ks, kc = rng.split(key_i)
            chunk = sample_chunk(x_local, ks, s,
                                 with_replacement=with_replacement, rng=rng)
            state, info = chunk_step(
                chunk, state, kc, max_iters=max_iters, tol=tol,
                candidates=candidates, impl=impl, precision=precision,
                rng=rng)
            chunk_infos.append(info)
        new_states.append(state)
        infos.append(ChunkInfo(*(torch.stack(list(f))
                                 for f in zip(*chunk_infos))))
    return _exchange_best(new_states), infos


def worker_sharded(
    X, key, *, mesh, k: int, s: int, chunks_per_worker: int,
    sync_every: int = 1, axes=("data",), max_iters: int = 300,
    tol: float = 1e-4, candidates: int = 3, impl: str = "auto",
    with_replacement: bool = True, precision: str = "auto", rng=rnd.TORCH,
) -> tuple[BigMeansState, ChunkInfo]:
    """Multi-worker Big-means: X row-sharded over the ``axes`` of ``mesh``;
    one chunk stream per worker, an incumbent exchange every
    ``sync_every`` chunks.  Returns the incumbent (counters summed over
    the workers) and the worker-major trace."""
    state, infos, _ = worker_sharded_rounds(
        X, key, mesh=mesh, k=k, s=s, chunks_per_worker=chunks_per_worker,
        sync_every=sync_every, axes=axes, max_iters=max_iters, tol=tol,
        candidates=candidates, impl=impl, with_replacement=with_replacement,
        precision=precision, rng=rng)
    return state, infos


def worker_sharded_rounds(
    X, key, *, mesh, k: int, s: int, chunks_per_worker: int,
    sync_every: int = 1, axes=("data",), max_iters: int = 300,
    tol: float = 1e-4, candidates: int = 3, impl: str = "auto",
    with_replacement: bool = True, precision: str = "auto", cfg=None,
    middlewares=None, resume: bool = True, rng=rnd.TORCH,
):
    """Worker-sharded Big-means with the middleware stack between windows.

    :func:`worker_sharded`'s run (the same windows, bitwise, when no
    middleware stops it), with checkpoint / resume and the time budget
    composing: after each window ``ctx.state`` is the per-worker state
    stack ``[W, ...]``, ``ctx.step`` the windows done and ``ctx.last_cid``
    the last chunk of each worker's window.  A restored checkpoint
    resumes at its window with its key and state stack.

    Returns ``(state, infos, ctx)``: the reduced incumbent (the workers
    agree after the exchange; counters summed over the workers), the
    worker-major trace of the windows that ran (``[W * windows *
    sync_every]``) and the loop's context.
    """
    topo = topo_lib.WorkerMesh(mesh, axes)
    if chunks_per_worker % sync_every:
        raise ValueError(
            f"sync_every ({sync_every}) must divide chunks_per_worker "
            f"({chunks_per_worker})")
    n_rounds = chunks_per_worker // sync_every
    worker_devs = topo.worker_devices()
    dev0 = worker_devs[0]
    xd = _cast_dataset(X, precision, dev0)
    shards = _worker_shards(xd, worker_devs)
    n = xd.shape[1]

    stack = mw.MiddlewareStack(middlewares or [])
    states = [init_state(k, n, device=dev) for dev in worker_devs]
    ctx = mw.EngineContext(cfg=cfg, key=key, metrics=RoundsMetrics(),
                           state=_stack_states(states, dev0),
                           t0=time.monotonic(), last_s=s, rng=rng)
    ckpt = stack.find(mw.Checkpoint)
    start_round = 0
    if resume and ckpt is not None and ckpt.maybe_restore(ctx, ctx.state):
        start_round = min(ctx.step, n_rounds)
        key = ctx.key
        states = [BigMeansState(*(f[w].to(dev) for f in ctx.state))
                  for w, dev in enumerate(worker_devs)]
    worker_keys = [rng.fold_in(key, w) for w in range(len(worker_devs))]
    stack.on_start(ctx)

    windows = []
    for r in range(start_round, n_rounds):
        states, infos = _sharded_segment(
            shards, worker_keys, r, states, s=s, n_rounds=n_rounds,
            sync_every=sync_every, max_iters=max_iters, tol=tol,
            candidates=candidates, impl=impl,
            with_replacement=with_replacement, precision=precision, rng=rng)
        ctx.state = _stack_states(states, dev0)
        ctx.info = _cat_infos(infos, dev0)
        ctx.step = r + 1
        ctx.last_cid = (r + 1) * sync_every - 1
        windows.append(infos)
        stack.after_window(ctx)
        if stack.should_stop(ctx):
            break

    stack.on_finish(ctx)
    # the workers agree on the incumbent after the exchange; the counters
    # are per worker and sum to the paper's global n_d and accepts
    stacked = _stack_states(states, dev0)
    final = BigMeansState(
        centroids=stacked.centroids[0], degenerate=stacked.degenerate[0],
        f_best=stacked.f_best[0],
        n_accepted=torch.sum(stacked.n_accepted).to(torch.int32),
        n_dist_evals=torch.sum(stacked.n_dist_evals))
    # [windows][W] -> worker-major: worker w's windows in order
    trace = _cat_infos([windows[i][w] for w in range(len(worker_devs))
                        for i in range(len(windows))], dev0)
    return final, trace, ctx
