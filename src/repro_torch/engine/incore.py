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
streams exchange incumbents.
"""
from __future__ import annotations

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core.bigmeans import (
    BigMeansState, ChunkInfo, _sync_streams, broadcast_state, chunk_step,
    chunk_step_batched, init_state, reduce_state, sample_chunk,
)
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
