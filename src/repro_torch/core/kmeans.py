"""K-means (Lloyd) local search — Algorithm 1 of the paper.

The reference runs a masked ``while_loop``; for one chunk that is a plain
loop that stops as soon as the search is inactive, which is what this is.
Each iteration is one ``ops.fused_step`` (kernel A on the card) followed by
the stop test on the host, so every iteration waits for the device once.

Convergence follows the paper's §5.7 rule, as the reference's ``_advance``:
stop when ``|f_prev - f_curr| <= tol * |f_prev|`` or at the iteration cap;
the first two iterations run unconditionally.  Degenerate (empty) clusters
keep their previous position and are reported in the result mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import precision as px


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # [k, n] f32
    objective: torch.Tensor    # 0-d f32: f(C_final, P)
    counts: torch.Tensor       # [k] f32 final cluster sizes
    degenerate: torch.Tensor   # [k] bool: counts == 0
    iterations: int            # Lloyd iterations
    assignments: torch.Tensor  # [m] int32


def lloyd(
    points: torch.Tensor,
    init_centroids: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    max_iters: int = 300,
    tol: float = 1e-4,
    impl: str = "auto",
    precision: str = "auto",
) -> KMeansResult:
    """Run Lloyd's algorithm from ``init_centroids`` on an in-memory chunk."""
    if weights is not None:
        raise NotImplementedError(
            "weighted Lloyd is not ported yet (ROADMAP queue 1 item 9)")
    precision = px.resolve(precision, points.dtype)
    points = points.float()
    c = init_centroids.float()
    k = c.shape[0]
    f_prev = f_curr = torch.tensor(float("inf"), device=points.device)
    it = 0
    active = max_iters > 0
    while active:
        sums, counts, f = ops.fused_step(points, c, impl=impl,
                                         precision=precision)
        c = torch.where(counts[:, None] > 0, sums / counts[:, None], c)
        f_prev, f_curr = f_curr, f
        it += 1
        converged = bool(torch.abs(f_prev - f_curr) <= tol * torch.abs(f_prev))
        active = it < max_iters and (it < 2 or not converged)

    # One last assignment against the final centroids: exact f(C, P), final
    # cluster sizes and the degeneracy mask (reference kmeans.py:131-146).
    ids, d = ops.assign(points, c, impl=impl, precision=precision)
    _, counts = ops.update(points, ids, k, impl=impl, precision=precision)
    return KMeansResult(
        centroids=c,
        objective=torch.sum(d),
        counts=counts,
        degenerate=counts == 0,
        iterations=it,
        assignments=ids,
    )
