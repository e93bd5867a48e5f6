"""K-means (Lloyd) local search — Algorithm 1 of the paper.

The reference runs a masked ``while_loop``; for one chunk that is a plain
loop that stops as soon as the search is inactive, which is what this is.
Each iteration is one ``ops.fused_step`` (kernel A on the card) followed by
the stop test on the host, so every iteration waits for the device once
(counted as ``host_sync.core.kmeans.stop`` while :mod:`repro_torch.tracing`
is on).

:func:`lloyd_batched` runs B searches at once: one ``ops.fused_step_batched``
(kernel D on the card) advances every stream per iteration, with the
reference's masked ``_advance`` — a stream that has stopped keeps its
centroids and counters frozen — and one host read of the ``[B]`` active
mask per iteration; the loop runs until no stream is active.

Under ``precision="int8"`` both loops run on the chunk quantized once at
Lloyd entry (kernels A8 / D8 on the card), while a full-width f32 view of
the chunk feeds the epilogue.  Under ``"bf16"`` the loops run on the chunk
in bf16 storage (A16 / D16) and ``"bf16x3"`` on the f32 chunk (A3 / D3).
The epilogue follows the reference (``kmeans.py:131-146``, ``:217-229``):
the final assignment — the accepting objective — runs f32 contractions
under bf16 and int8 (f32 kernel B on the widened bf16 view, or on the
full-width view) and bf16x3 contractions under bf16x3 (B3); the final
counts come from the update at the policy on the loop's chunk (C16, C3),
at f32 on the full-width view under int8.

Convergence follows the paper's §5.7 rule, as the reference's ``_advance``:
stop when ``|f_prev - f_curr| <= tol * |f_prev|`` or at the iteration cap;
the first two iterations run unconditionally.  Degenerate (empty) clusters
keep their previous position and are reported in the result mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.kernels import precision as px


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # [k, n] f32                (batched: [B, k, n])
    objective: torch.Tensor    # 0-d f32: f(C_final, P)            ([B])
    counts: torch.Tensor       # [k] f32 final cluster sizes       ([B, k])
    degenerate: torch.Tensor   # [k] bool: counts == 0             ([B, k])
    iterations: int            # Lloyd iterations  (batched: int32 [B] tensor)
    assignments: torch.Tensor  # [m] int32                         ([B, m])


def _split_views(points, precision: str):
    """(loop view, epilogue view) of a chunk under ``precision``.

    Under int8 the loop runs on the codes (quantized here unless the chunk
    arrives quantized) and the epilogue on the full-width view — for a
    pre-quantized chunk its dequantized values, the best view there is.
    The float policies run both on the chunk in its storage (bf16 under
    ``'bf16'``, f32 otherwise).
    """
    if precision == "int8":
        full = (px.dequantize(points)
                if isinstance(points, px.QuantizedChunk) else points.float())
        return px.as_quantized(points), full
    points = px.cast_storage(points, precision)
    return points, points


def _epilogue_precisions(precision: str) -> tuple[str, str]:
    """(assign, update) precisions of the epilogue (reference
    ``kmeans.py:139-144``): the accepting objective never contracts in
    bf16 or int8."""
    eval_prec = "f32" if precision in ("bf16", "int8") else precision
    upd_prec = "f32" if precision == "int8" else precision
    return eval_prec, upd_prec


def lloyd(
    points,
    init_centroids: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    max_iters: int = 300,
    tol: float = 1e-4,
    impl: str = "auto",
    precision: str = "auto",
) -> KMeansResult:
    """Run Lloyd's algorithm from ``init_centroids`` on an in-memory chunk
    (a tensor, or under int8 possibly a :class:`~.precision.QuantizedChunk`).

    ``weights`` ([m], optional) is the weighted variant of the coreset,
    K-means|| and DA-MSSC baselines: w_i multiplies both the objective and
    the centroid update, every step the weighted two-pass route of
    :func:`~repro_torch.kernels.ops.fused_step` (kernel B for its ids on
    the card).
    """
    precision = ops.resolve_precision(precision, points)
    points, points_eval = _split_views(points, precision)
    c = init_centroids.float()
    k = c.shape[0]
    f_prev = f_curr = torch.tensor(float("inf"), device=points.device)
    tracing.count("host_sync.core.kmeans.init")       # a copy, waited for
    it = 0
    active = max_iters > 0
    with tracing.span("core.kmeans.lloyd", c):
        while active:
            sums, counts, f = ops.fused_step(points, c, weights=weights,
                                             impl=impl, precision=precision)
            c = torch.where(counts[:, None] > 0, sums / counts[:, None], c)
            f_prev, f_curr = f_curr, f
            it += 1
            converged = bool(
                torch.abs(f_prev - f_curr) <= tol * torch.abs(f_prev))
            active = it < max_iters and (it < 2 or not converged)
        tracing.count("host_sync.core.kmeans.stop", it)

    # One last assignment against the final centroids: exact f(C, P), final
    # cluster sizes and the degeneracy mask (reference kmeans.py:131-146).
    eval_prec, upd_prec = _epilogue_precisions(precision)
    with tracing.span("core.kmeans.epilogue", c):
        ids, d = ops.assign(points_eval, c, impl=impl, precision=eval_prec)
        _, counts = ops.update(points_eval, ids, k, weights=weights,
                               impl=impl, precision=upd_prec)
        f = torch.sum(d) if weights is None else torch.sum(d * weights)
    return KMeansResult(
        centroids=c,
        objective=f,
        counts=counts,
        degenerate=counts == 0,
        iterations=it,
        assignments=ids,
    )


def lloyd_batched(
    points,
    init_centroids: torch.Tensor,
    *,
    max_iters: int = 300,
    tol: float = 1e-4,
    impl: str = "auto",
    precision: str = "auto",
) -> KMeansResult:
    """B concurrent Lloyd searches: ``points`` [B, s, n], ``init`` [B, k, n].

    Every field of the result gains a leading batch axis.  Each stream stops
    updating once its own test fires (the reference's masked ``_advance``),
    so ``iterations`` matches B independent :func:`lloyd` calls exactly.

    The epilogue (final assignment, objective and counts) runs stream by
    stream through ``ops.assign`` / ``ops.update`` with the caller's impl,
    as :func:`lloyd` does: kernels B and C on the card.  This departs from
    the reference, whose batched epilogue always runs on the jnp oracle
    (``repro/core/kmeans.py:205-212``); on the CPU both run the oracle.
    Under int8 the loop runs on the chunks quantized once (one scale row
    per stream) and the epilogue on the full-width view, in f32.
    """
    precision = ops.resolve_precision(precision, points)
    points, points_eval = _split_views(points, precision)
    c = init_centroids.float()
    batch, k = c.shape[0], c.shape[1]
    dev = points.device
    f_prev = f_curr = torch.full((batch,), float("inf"), device=dev)
    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    active = torch.full((batch,), max_iters > 0, device=dev)
    steps = 0
    with tracing.span("core.kmeans.lloyd", c):
        while bool(active.any()):
            sums, counts, f = ops.fused_step_batched(points, c, impl=impl,
                                                     precision=precision)
            new_c = torch.where(counts[..., None] > 0,
                                sums / counts[..., None], c)
            c = torch.where(active[:, None, None], new_c, c)
            f_prev = torch.where(active, f_curr, f_prev)
            f_curr = torch.where(active, f, f_curr)
            it = it + active.to(torch.int32)
            converged = torch.abs(f_prev - f_curr) <= tol * torch.abs(f_prev)
            active = active & (it < max_iters) & ((it < 2) | ~converged)
            steps += 1
        tracing.count("host_sync.core.kmeans.stop", steps + 1)

    eval_prec, upd_prec = _epilogue_precisions(precision)
    ids, objective, final_counts = [], [], []
    with tracing.span("core.kmeans.epilogue", c):
        for b in range(batch):
            ids_b, d_b = ops.assign(points_eval[b], c[b], impl=impl,
                                    precision=eval_prec)
            _, counts_b = ops.update(points_eval[b], ids_b, k, impl=impl,
                                     precision=upd_prec)
            ids.append(ids_b)
            objective.append(torch.sum(d_b))
            final_counts.append(counts_b)
        counts = torch.stack(final_counts)
    return KMeansResult(
        centroids=c,
        objective=torch.stack(objective),
        counts=counts,
        degenerate=counts == 0,
        iterations=it,
        assignments=torch.stack(ids),
    )
