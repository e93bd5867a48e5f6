"""K-means++ seeding (Algorithm 2) and degenerate-cluster re-seeding.

As in the reference: fresh seeding treats every slot as degenerate;
Big-means re-initialization re-samples only the degenerate slots, measuring
distances against the surviving centroids and the seeds already placed.
Each new seed is the best of ``candidates`` D²-sampled proposals ("greedy
K-means++").  The D² draw is ``argmax(gumbel + logits)``, which is what
``jax.random.categorical`` computes, drawn through the key-tree backend.

The key schedule is the reference's: one ``split`` per slot, degenerate or
not; the work of a surviving slot is skipped, its key is still consumed.

A bf16 chunk is seeded as it is stored (reference ``kmeanspp.py:55-56``):
its distances contract in bf16 (``pairwise_sqdist_ref`` follows the
dtype), the point norms are f32 of the stored values, and the chosen
candidates are widened to the f32 centroids.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch import tracing
from repro_torch.kernels.ref import pairwise_sqdist_ref

_BIG = 1e30


def _safe_d2_logits(d: torch.Tensor) -> torch.Tensor:
    """log-weights for D² sampling; uniform when all distances are 0."""
    total = torch.sum(d)
    logits = torch.log(torch.clamp_min(d, 1e-30))
    return torch.where(total > 0, logits, torch.zeros_like(d))


def seed(
    points: torch.Tensor,
    key,
    k: int,
    *,
    init: torch.Tensor | None = None,
    degenerate: torch.Tensor | None = None,
    candidates: int = 3,
    weights: torch.Tensor | None = None,
    rng=rnd.TORCH,
) -> torch.Tensor:
    """Return [k, n] centroids; non-degenerate rows of ``init`` are kept.

    ``weights`` (optional, [s]) makes this the weighted D² sampling of the
    coreset, K-means|| and DA-MSSC baselines: sampling probabilities and
    potentials are both scaled by w_i.

    The host reads the degenerate mask once, and each seeded slot's pick
    twice (``cands[b]`` and ``newd[:, b]``: indexing by a 0-d tensor reads
    it): on a CUDA device each read waits for the card.
    """
    with tracing.span("core.kmeanspp.seed", points):
        return _seed(points, key, k, init=init, degenerate=degenerate,
                     candidates=candidates, weights=weights, rng=rng)


def _seed(points, key, k: int, *, init, degenerate, candidates: int,
          weights, rng) -> torch.Tensor:
    if points.dtype != torch.bfloat16:
        points = points.float()
    s, n = points.shape
    dev = points.device
    w = None if weights is None else weights.float()
    if init is None:
        init = torch.zeros((k, n), dtype=torch.float32, device=dev)
        degenerate = torch.ones((k,), dtype=torch.bool, device=dev)
    if degenerate is None:
        raise ValueError("init without a degenerate mask")
    c = init.float().clone()

    # Point norms hoisted out of the seeding loop (f32 of the stored values).
    pf = points.float()
    x2 = torch.sum(pf * pf, dim=-1, keepdim=True)
    # Distance of every point to the nearest *surviving* centroid.
    d_all = pairwise_sqdist_ref(points, c, x2)                     # [s, k]
    d_all = torch.where(degenerate[None, :], _BIG, d_all)
    d = torch.clamp_max(torch.min(d_all, dim=1).values, _BIG)      # [s]

    mask = degenerate.tolist()
    tracing.count("host_sync.core.kmeanspp.mask")
    for j, is_deg in enumerate(mask):
        key, k1 = rng.split(key)
        if not is_deg:
            continue
        logits = _safe_d2_logits(d if w is None else d * w)
        noise = rng.gumbel(k1, (candidates, s), dev)
        cand_idx = torch.argmax(noise + logits[None, :], dim=1)    # [L]
        cands = points[cand_idx]                                   # [L, n]
        dc = pairwise_sqdist_ref(points, cands, x2)                # [s, L]
        newd = torch.minimum(d[:, None], dc)                       # [s, L]
        pot = newd if w is None else newd * w[:, None]
        b = torch.argmin(torch.sum(pot, dim=0))
        c[j] = cands[b]
        d = newd[:, b]
    tracing.count("host_sync.core.kmeanspp.pick", 2 * sum(mask))
    return c


def kmeanspp(points: torch.Tensor, key, k: int, *, candidates: int = 3,
             weights: torch.Tensor | None = None,
             rng=rnd.TORCH) -> torch.Tensor:
    """Fresh K-means++ seeding of k centers (paper Algorithm 2)."""
    return seed(points, key, k, candidates=candidates, weights=weights,
                rng=rng)


def seed_batched(
    points: torch.Tensor,
    keys,
    k: int,
    *,
    init: torch.Tensor,
    degenerate: torch.Tensor,
    candidates: int = 3,
    rng=rnd.TORCH,
) -> torch.Tensor:
    """Per-stream re-seeding for B streams: points [B, s, n], ``keys`` one
    per stream, init [B, k, n], degenerate [B, k] -> [B, k, n].

    The reference vmaps :func:`seed` over the streams.  A stream with no
    degenerate slot gets ``init`` back unchanged from :func:`seed` (every
    row is kept), so only the streams with a degenerate slot are seeded.
    """
    with tracing.span("core.kmeanspp.seed", points):
        c = init.float().clone()
        seeded = degenerate.any(dim=1).tolist()
        tracing.count("host_sync.core.kmeanspp.mask")
        for b, any_deg in enumerate(seeded):
            if any_deg:
                c[b] = _seed(points[b], keys[b], k, init=init[b],
                             degenerate=degenerate[b], candidates=candidates,
                             weights=None, rng=rng)
        return c
