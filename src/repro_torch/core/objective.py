"""MSSC objective (eq. (1) of the paper) and full-dataset evaluation."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

EVAL_BATCH = 262_144


def chunk_objective(points: torch.Tensor, centroids: torch.Tensor, *,
                    impl: str = "auto") -> torch.Tensor:
    """f(C, P) = sum_i min_j ||p_i - c_j||^2 on an in-memory chunk."""
    _, d = ops.assign(points, centroids, impl=impl)
    return torch.sum(d)


def full_assignment(points: torch.Tensor, centroids: torch.Tensor, *,
                    batch: int = EVAL_BATCH, impl: str = "auto"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Final pass of Algorithm 3 (line 14): assign every point.

    Streams the dataset in ``batch``-row slices (bounded working set): one
    launch of kernel B per slice on the card, the oracle on the CPU.
    Returns (ids int32 [m], f(C, X) f32).
    """
    impl = ops.resolve_impl(impl, points.device)
    c = centroids.to(device=points.device, dtype=torch.float32).contiguous()
    ids, d = [], []
    for i in range(0, points.shape[0], batch):
        ids_i, d_i = ops.assign(points[i:i + batch], c, impl=impl)
        ids.append(ids_i)
        d.append(d_i)
    ids_all = torch.cat(ids)
    return ids_all, torch.sum(torch.cat(d))


def full_objective(points: torch.Tensor, centroids: torch.Tensor, *,
                   batch: int = EVAL_BATCH, impl: str = "auto"
                   ) -> torch.Tensor:
    """Objective over the whole dataset, streamed in batches."""
    return full_assignment(points, centroids, batch=batch, impl=impl)[1]
