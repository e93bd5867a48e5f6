"""Carry Big-means state and quantized chunks across the two packages as
numpy arrays.

A reference ``BigMeansState`` read out as numpy becomes the port's state
(:func:`state_from_numpy`), and back (:func:`state_to_numpy`), so a run can
start from an incumbent of the other package mid-trajectory.  Both take a
state with a leading batch axis (the batched driver's per-stream states)
as they take a single one: every field keeps its shape.  A quantized chunk
travels as its numpy ``(q, scale)`` pair (:func:`quantized_from_numpy`,
:func:`quantized_to_numpy`), so both packages can be fed the same codes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bigmeans import BigMeansState
from repro_torch.kernels.precision import QuantizedChunk


def state_from_numpy(centroids, degenerate, f_best, n_accepted,
                     n_dist_evals, *, device) -> BigMeansState:
    """The port's state from the five fields of a reference state (single
    or batched)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return BigMeansState(
        centroids=t(centroids, torch.float32),
        degenerate=t(degenerate, torch.bool),
        f_best=t(f_best, torch.float32),
        n_accepted=t(n_accepted, torch.int32),
        n_dist_evals=t(n_dist_evals, torch.float32),
    )


def state_to_numpy(state: BigMeansState) -> tuple[np.ndarray, ...]:
    """(centroids, degenerate, f_best, n_accepted, n_dist_evals) as numpy,
    in the reference's dtypes (f32, bool, f32, int32, f32)."""
    return tuple(field.detach().cpu().numpy() for field in state)


def quantized_from_numpy(q, scale, *, device) -> QuantizedChunk:
    """The port's :class:`QuantizedChunk` from int8 codes ``[..., m, n]``
    and f32 scales ``[..., n]`` (a reference chunk's fields as numpy)."""
    return QuantizedChunk(
        torch.as_tensor(np.array(q, dtype=np.int8), device=device),
        torch.as_tensor(np.array(scale, dtype=np.float32), device=device))


def quantized_to_numpy(qx: QuantizedChunk) -> tuple[np.ndarray, np.ndarray]:
    """(q int8, scale f32) as numpy: the fields of the reference's
    ``QuantizedChunk``."""
    return qx.q.detach().cpu().numpy(), qx.scale.detach().cpu().numpy()
