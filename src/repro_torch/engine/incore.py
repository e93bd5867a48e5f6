"""In-core execution: the sequential chunk loop (the paper's Algorithm 3).

The reference scans a jitted body over ``split(key, n_chunks)``; here the
scan is a Python loop over the same key tree: chunk ``i`` gets
``split(key, n_chunks)[i]``, split again into ``(ks, kc)`` — ``ks`` samples
the chunk, ``kc`` drives K-means++ re-seeding.
"""
from __future__ import annotations

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.core.bigmeans import (
    BigMeansState, ChunkInfo, chunk_step, init_state, sample_chunk,
)
from repro_torch.kernels import precision as px


def _cast_dataset(X, precision, device: torch.device) -> torch.Tensor:
    """The dataset as contiguous f32 on ``device`` (f32 is the only ported
    storage policy; others raise)."""
    if isinstance(X, torch.Tensor):
        px.resolve(precision, X.dtype)
    else:
        px.resolve(precision, torch.float32)
    return devices.to_f32(X, device)


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
