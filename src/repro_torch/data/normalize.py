"""Feature normalization (the paper evaluates min-max normalized variants)."""
from __future__ import annotations

import torch


def minmax_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    lo = torch.amin(x, dim=0, keepdim=True)
    hi = torch.amax(x, dim=0, keepdim=True)
    return (x - lo) / torch.clamp_min(hi - lo, eps)


def streaming_minmax(chunks) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass over an iterable of chunks -> (lo, hi) per feature.

    The paper notes normalization is ideally folded into data collection; this
    helper is the single-extra-pass fallback for stored datasets.
    """
    lo = hi = None
    for c in chunks:
        clo = torch.amin(c, dim=0)
        chi = torch.amax(c, dim=0)
        lo = clo if lo is None else torch.minimum(lo, clo)
        hi = chi if hi is None else torch.maximum(hi, chi)
    return lo, hi
