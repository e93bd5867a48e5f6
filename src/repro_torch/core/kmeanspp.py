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

The host reads the degenerate mask once (none for a fresh seeding) and
nothing in the slot loop: each slot's pick stays on the device.  An f32
chunk on the card with no weights and at most ``kpp_probe.MAX_L``
candidates of ``kpp_probe.MAX_N`` features runs each slot as two
hand-written launches (:class:`~repro_torch.kernels.kpp_probe.SlotChain`:
the draw, kernel G, and the probe, kernel P), so the host queues the slots
ahead of the card.  That is a stated departure from the reference: P
associates ``(c2 - 2 dots) + x2``, where the oracle chain takes ``x2 - 2
dots + c2``, so on the card decisions near ties may differ.  Every other
chunk (the CPU, ``impl="ref"``, weighted seeds, bf16) runs the oracle
chain.
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch import tracing
from repro_torch.kernels import kpp_probe as kpp
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pairwise_sqdist_ref

_BIG = 1e30


def seed(
    points: torch.Tensor,
    key,
    k: int,
    *,
    init: torch.Tensor | None = None,
    degenerate: torch.Tensor | None = None,
    candidates: int = 3,
    weights: torch.Tensor | None = None,
    impl: str = "auto",
    rng=rnd.TORCH,
) -> torch.Tensor:
    """Return [k, n] centroids; non-degenerate rows of ``init`` are kept.

    ``weights`` (optional, [s]) makes this the weighted D² sampling of the
    coreset, K-means|| and DA-MSSC baselines: sampling probabilities and
    potentials are both scaled by w_i.  ``impl`` (``'auto'``, ``'cuda'``,
    ``'ref'``, as :func:`repro_torch.kernels.ops.resolve_impl`) chooses
    between the slot kernels and the oracle chain where both apply.
    """
    with tracing.span("core.kmeanspp.seed", points):
        return _seed(points, key, k, init=init, degenerate=degenerate,
                     candidates=candidates, weights=weights, impl=impl,
                     rng=rng)


def _seed(points, key, k: int, *, init, degenerate, candidates: int,
          weights, impl, rng) -> torch.Tensor:
    if points.dtype != torch.bfloat16:
        points = points.float()
    points = points.contiguous()        # once, before the slot loop
    s, n = points.shape
    dev = points.device
    w = None if weights is None else weights.float()
    if init is None:
        c = torch.zeros((k, n), dtype=torch.float32, device=dev)
        mask = [True] * k               # a fresh seeding: every slot
    else:
        if degenerate is None:
            raise ValueError("init without a degenerate mask")
        c = init.float().clone(memory_format=torch.contiguous_format)
        mask = degenerate.tolist()
        tracing.count("host_sync.core.kmeanspp.mask")
    on_card = (ops.resolve_impl(impl, dev) == "cuda"
               and points.dtype == torch.float32 and w is None
               and kpp.fits(candidates, n))

    # Distance of every point to the nearest *surviving* centroid: none
    # survives a fresh seeding, so every distance is _BIG.
    x2 = None
    if not on_card or not all(mask):
        # Point norms hoisted out of the seeding loop (f32 of the stored
        # values).
        pf = points.float()
        x2 = torch.sum(pf * pf, dim=-1, keepdim=True)
    if all(mask):
        d = torch.full((s,), _BIG, dtype=torch.float32, device=dev)
    else:
        d_all = pairwise_sqdist_ref(points, c, x2)                 # [s, k]
        d_all = torch.where(degenerate[None, :], _BIG, d_all)
        d = torch.clamp_max(torch.min(d_all, dim=1).values, _BIG)  # [s]

    tracing.count("core.kmeanspp.probe." + ("kernel" if on_card else "plain"),
                  sum(mask))
    if on_card:
        chain = kpp.SlotChain(points, d.contiguous(), c, candidates)
        for j, is_deg in enumerate(mask):
            key, k1 = rng.split(key)
            if is_deg:
                chain.slot(rng.gumbel(k1, (candidates, s), dev), j)
        chain.finish()
        return c
    for j, is_deg in enumerate(mask):
        key, k1 = rng.split(key)
        if not is_deg:
            continue
        noise = rng.gumbel(k1, (candidates, s), dev)
        _, cands = kpp.kpp_draw_plain(points, noise,               # [L, n]
                                      d if w is None else d * w)
        dc = pairwise_sqdist_ref(points, cands, x2)                # [s, L]
        newd = torch.minimum(d[:, None], dc)                       # [s, L]
        pot = newd if w is None else newd * w[:, None]
        # the pick stays on the device: indexing by a 0-d tensor would
        # read it
        b = torch.argmin(torch.sum(pot, dim=0), dim=0, keepdim=True)
        c[j] = cands.index_select(0, b)[0]
        d = newd.index_select(1, b)[:, 0]
    return c


def kmeanspp(points: torch.Tensor, key, k: int, *, candidates: int = 3,
             weights: torch.Tensor | None = None, impl: str = "auto",
             rng=rnd.TORCH) -> torch.Tensor:
    """Fresh K-means++ seeding of k centers (paper Algorithm 2)."""
    return seed(points, key, k, candidates=candidates, weights=weights,
                impl=impl, rng=rng)


def seed_batched(
    points: torch.Tensor,
    keys,
    k: int,
    *,
    init: torch.Tensor,
    degenerate: torch.Tensor,
    candidates: int = 3,
    impl: str = "auto",
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
                             weights=None, impl=impl, rng=rng)
        return c
