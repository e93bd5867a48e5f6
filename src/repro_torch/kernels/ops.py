"""Public wrappers around the K-means kernels (the reference's ``ops.py``).

Dispatch policy
---------------
* ``'cuda'``        — the hand-written CUDA kernels; CUDA tensors only.
* ``'ref'``         — the plain PyTorch oracles of :mod:`.ref`, on whatever
                      device the tensors are on.
* ``'ref_chunked'`` — the oracle over row blocks of ``chunk`` rows (bounds
                      the [m, k] distance working set for big m).
* ``'auto'``        — ``'cuda'`` for a CUDA tensor, ``'ref'`` for a CPU one.

There is no demotion and no fallback: a kernel that fails to build or to
launch raises.  Outside the fused envelope, ``fused_step`` takes the
two-pass route through kernels B and C on the card (through the oracles
under the ref impls), and ``fused_step_batched`` takes it stream by stream.  Each kernel wrapper counts its launches; read them
with :func:`launch_counts` and zero them with :func:`reset_launch_counts`.

``precision`` follows :mod:`.precision`: only ``'f32'`` is ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import distance, ref
from repro_torch.kernels import fused_step as fused
from repro_torch.kernels import precision as px
from repro_torch.kernels import update as upd

IMPLS = ("cuda", "ref", "ref_chunked")

_WEIGHTS = ("weighted steps are not ported yet (ROADMAP queue 1 item 9, "
            "the §5 baselines that use them)")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, per kernel."""
    return {"fused_step": fused.launches, "assign": distance.launches,
            "update": upd.launches,
            "fused_step_batched": fused.batched_launches}


def reset_launch_counts() -> None:
    fused.launches = 0
    fused.batched_launches = 0
    distance.launches = 0
    upd.launches = 0


def resolve_impl(impl: str | None, device: torch.device) -> str:
    """Resolve an ``impl`` knob for tensors on ``device``.

    ``'auto'``/None -> ``'cuda'`` on a CUDA device, ``'ref'`` elsewhere.
    ``'cuda'`` for a CPU device raises: the kernels need the card.
    """
    if impl is None or impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "ref"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: ('auto',) + {IMPLS}")
    if impl == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got tensors on {device}")
    return impl


def assign(x: torch.Tensor, c: torch.Tensor, *, impl: str = "auto",
           precision: str = "auto", chunk: int = 65536
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid: x [m,n], c [k,n] -> (ids int32 [m], d f32 [m])."""
    impl = resolve_impl(impl, x.device)
    precision = px.resolve(precision, x.dtype)
    if impl == "cuda":
        return distance.assign_f32(x, c)
    if impl == "ref":
        return ref.assign_ref(x, c, precision=precision)
    parts = [ref.assign_ref(x[i:i + chunk], c, precision=precision)
             for i in range(0, x.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def update(x: torch.Tensor, ids: torch.Tensor, k: int, *,
           weights: torch.Tensor | None = None, impl: str = "auto",
           precision: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster sums/counts: x [m,n], ids [m] -> (sums [k,n], counts [k])."""
    if weights is not None:
        raise NotImplementedError(_WEIGHTS)
    impl = resolve_impl(impl, x.device)
    precision = px.resolve(precision, x.dtype)
    if impl == "cuda":
        return upd.update_f32(x, ids, k)
    return ref.update_ref(x, ids, k, precision=precision)


def fused_step(x: torch.Tensor, c: torch.Tensor, *,
               weights: torch.Tensor | None = None, impl: str = "auto",
               precision: str = "auto"
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration's (sums, counts, objective): kernel A inside the
    fused envelope, two passes (assign + update) outside it."""
    if weights is not None:
        raise NotImplementedError(_WEIGHTS)
    impl = resolve_impl(impl, x.device)
    precision = px.resolve(precision, x.dtype)
    k = c.shape[0]
    if impl == "cuda" and fused.fits(k, c.shape[1]):
        return fused.fused_step_f32(x, c)
    ids, d = assign(x, c, impl=impl, precision=precision)
    sums, counts = update(x, ids, k, impl=impl, precision=precision)
    return sums, counts, torch.sum(d)


def fused_step_batched(x: torch.Tensor, c: torch.Tensor, *,
                       impl: str = "auto", precision: str = "auto"
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B concurrent Lloyd iterations: x [B,m,n], c [B,k,n] -> (sums [B,k,n],
    counts [B,k], obj [B]).

    ``'cuda'``: kernel D inside the fused envelope (one launch for all
    streams), else the two-pass route through kernels B and C stream by
    stream.  ``'ref'`` / ``'ref_chunked'``: the plain version, as the
    reference's batched oracle (``ops._fused_step_batched_ref``).
    """
    impl = resolve_impl(impl, x.device)
    precision = px.resolve(precision, x.dtype)
    if impl != "cuda":
        return fused.fused_step_batched_plain(x, c)
    if fused.fits_batched(c.shape[1], c.shape[2]):
        return fused.fused_step_batched_f32(x, c)
    sums, counts, obj = zip(*(fused_step(x[b], c[b], impl="cuda",
                                         precision=precision)
                              for b in range(x.shape[0])))
    return torch.stack(sums), torch.stack(counts), torch.stack(obj)
