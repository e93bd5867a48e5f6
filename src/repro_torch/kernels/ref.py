"""Plain PyTorch versions of the kernels (the reference's ``kernels/ref.py``).

These are the semantic ground truth of the port: on the CPU they are the
production path, and on the card ``chip_smoke.py`` and the ``cuda`` tests
hold every CUDA kernel against them on the same tensors.  Accumulation —
norms, sums, counts, objective — is float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import precision as px


def pairwise_sqdist_ref(x: torch.Tensor, c: torch.Tensor,
                        x2: torch.Tensor | None = None,
                        *, precision: str | None = None) -> torch.Tensor:
    """Squared distances between rows of x [m,n] and c [k,n] -> [m,k].

    Associates as ``x2 - 2*dots + c2`` and clamps at 0, as the reference
    does (``repro/kernels/ref.py``).  ``x2`` (optional [m,1]) hoists the
    point norms out of loops that probe many candidate centroid sets.
    """
    prec = px.from_dtype(x.dtype) if precision is None else precision
    px.check(prec)
    if x2 is None:
        x2 = px.sqnorm(x, keepdim=True)
    c2 = px.sqnorm(c)[None, :]
    dots = px.dot(x, c, ([1], [1]), prec)
    d = x2 - 2.0 * dots + c2
    return torch.clamp_min(d, 0.0)


def assign_ref(x: torch.Tensor, c: torch.Tensor,
               *, precision: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: (ids int32 [m], sq_dist f32 [m]).

    Ties go to the lowest index (``torch.min`` returns the first minimum).
    """
    d = pairwise_sqdist_ref(x, c, precision=precision)
    mind, ids = torch.min(d, dim=1)
    return ids.to(torch.int32), mind


def update_ref(x: torch.Tensor, ids: torch.Tensor, k: int,
               *, precision: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster feature sums f32 [k,n] and counts f32 [k].

    ``ids`` outside [0, k) contribute nothing (used for padding).
    """
    prec = px.from_dtype(x.dtype) if precision is None else precision
    px.check(prec)
    lanes = torch.arange(k, device=ids.device, dtype=ids.dtype)
    onehot = (ids[:, None] == lanes[None, :]).float()         # [m,k]
    sums = px.dot(onehot, x, ([0], [0]), prec)                # [k,n]
    counts = torch.sum(onehot, dim=0)                         # [k]
    return sums, counts


def min_update_ref(d: torch.Tensor, x: torch.Tensor,
                   c_new: torch.Tensor) -> torch.Tensor:
    """K-means++ distance relaxation: d <- min(d, ||x - c_new||^2)."""
    diff = x.float() - c_new.float()[None, :]
    return torch.minimum(d, torch.sum(diff * diff, dim=-1))
