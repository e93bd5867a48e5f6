"""A plain Big-means and full-data assignment, for the control.

The control puts this reference in the program's place, computed in the
precision just below the one the configurations state: ``"tf32"`` (the
card's TF32 matrix products, or on the CPU the operands rounded to TF32's
10-bit mantissa) where the program runs float32 with TF32 off.  At
``"f32"`` it is a correct Big-means, which the judge must accept.  Chunks
are drawn with the sampler's key tree (:func:`perfbench.reference.judge.
chunk_rows`), so the judge finds the winning chunk; seeding is its own
(greedy K-means++, ``candidates`` D² draws a slot, ``torch.multinomial``).
"""
from __future__ import annotations

import torch

from perfbench.gen import rng
from perfbench.reference.judge import chunk_rows


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return a @ b
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    if a.is_cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return _round_tf32(a) @ _round_tf32(b)


def sqdist(x: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (c * c).sum(1)
    return (x2 - 2.0 * _mm(x, c.T, precision) + c2[None, :]).clamp_min_(0.0)


def assign(x: torch.Tensor, c: torch.Tensor, precision: str,
           block: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    ids, d = [], []
    for lo in range(0, x.shape[0], block):
        v, i = sqdist(x[lo:lo + block], c, precision).min(1)
        ids.append(i)
        d.append(v)
    return torch.cat(ids), torch.cat(d)


def seed_slots(P: torch.Tensor, C: torch.Tensor, empty: torch.Tensor,
               gen: torch.Generator, candidates: int,
               precision: str) -> torch.Tensor:
    """Greedy K-means++ on the slots of ``C`` marked ``empty``."""
    C = C.clone()
    held = ~empty
    if bool(held.any()):
        d = sqdist(P, C[held], precision).min(1).values
    else:
        d = torch.full((P.shape[0],), 1.0, device=P.device)
    for j in torch.nonzero(empty).flatten().tolist():
        w = d if float(d.sum()) > 0 else torch.ones_like(d)
        cand = torch.multinomial(w, candidates, replacement=True,
                                 generator=gen)
        newd = torch.minimum(d[:, None],
                             sqdist(P, P[cand], precision))
        b = int(newd.sum(0).argmin())
        C[j] = P[cand[b]]
        d = newd[:, b]
    return C


def lloyd(P: torch.Tensor, C: torch.Tensor, *, precision: str, tol: float,
          max_iters: int):
    k = C.shape[0]
    f_prev = f_curr = float("inf")
    for it in range(1, max_iters + 1):
        ids, d = assign(P, C, precision)
        f = float(d.sum())
        counts = torch.bincount(ids, minlength=k).float()
        sums = torch.zeros_like(C).index_add_(0, ids, P)
        C = torch.where(counts[:, None] > 0, sums / counts[:, None], C)
        f_prev, f_curr = f_curr, f
        if it >= 2 and abs(f_prev - f_curr) <= tol * abs(f_prev):
            break
    ids, d = assign(P, C, precision)
    counts = torch.bincount(ids, minlength=k)
    return C, float(d.sum()), counts == 0


def big_means(X: torch.Tensor, *, k: int, s: int, n_chunks: int, seed: int,
              precision: str, tol: float = 1e-4, max_iters: int = 300,
              candidates: int = 3):
    """(centroids, objective on the winning chunk, trace of ``(chunk,
    f_new, accepted)``) of a sequential Big-means seeded ``seed``."""
    m, n = X.shape
    C = torch.zeros((k, n), device=X.device)
    empty = torch.ones(k, dtype=torch.bool, device=X.device)
    f_best = float("inf")
    trace = []
    for i, key_i in enumerate(rng.split(rng.key(seed), n_chunks)):
        P = X.index_select(0, chunk_rows(seed, i, m=m, s=s,
                                         n_chunks=n_chunks, device=X.device))
        gen = rng.generator(rng.split(key_i)[1], X.device)
        init = seed_slots(P, C, empty, gen, candidates, precision) \
            if bool(empty.any()) else C
        C_new, f_new, empty_new = lloyd(P, init, precision=precision,
                                        tol=tol, max_iters=max_iters)
        accepted = f_new < f_best
        if accepted:
            C, f_best, empty = C_new, f_new, empty_new
        trace.append((i, f_new, accepted))
    return C, f_best, trace


def evaluate(X: torch.Tensor, C: torch.Tensor, precision: str):
    """(ids, f) of a full-data assignment, f summed in float32."""
    ids, d = assign(X, C, precision)
    return ids, float(d.sum())
