"""Plain PyTorch versions of the kernels (the reference's ``kernels/ref.py``).

These are the semantic ground truth of the port: on the CPU they are the
production path, and on the card ``chip_smoke.py`` and the ``cuda`` tests
hold every CUDA kernel against them on the same tensors.  Accumulation —
norms, sums, counts, objective — is float32; the contractions run under
the ``precision`` policy (:func:`repro_torch.kernels.precision.dot`; under
``'int8'`` exact int32, :func:`repro_torch.kernels.precision.intdot`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import precision as px


def pairwise_sqdist_ref(x, c: torch.Tensor,
                        x2: torch.Tensor | None = None,
                        *, precision: str | None = None) -> torch.Tensor:
    """Squared distances between rows of x [m,n] and c [k,n] -> [m,k].

    Associates as ``x2 - 2*dots + c2`` and clamps at 0, as the reference
    does (``repro/kernels/ref.py``).  ``x2`` (optional [m,1]) hoists the
    point norms out of loops that probe many candidate centroid sets.
    ``precision=None`` follows x's dtype (a bf16 tensor contracts in bf16).
    Under ``'bf16'`` / ``'bf16x3'`` only the dot runs at the policy: ``x2``
    comes from x as given (for an f32 chunk, its f32 values, as the
    reference's oracle takes it) and ``c2`` from the f32 centroids.

    Under ``'int8'`` (or for a :class:`~.precision.QuantizedChunk` ``x``)
    the contraction is the int8 scheme: ``dots = intdot(xq, cq) * t``,
    ``c2`` from the full-width centroids, ``x2`` from the dequantized codes,
    associated as ``(c2 - 2*dots) + x2`` — the order the kernels use
    (reference ``ref.py:46-49``).
    """
    prec = px.from_dtype(x.dtype) if precision is None else px.check(
        precision)
    if prec == "int8":
        qx = px.as_quantized(x)
        cq, t = px.quantize_centroids(c, qx.scale)
        if x2 is None:
            x2 = px.sqnorm_in_order(px.dequantize(qx), keepdim=True)
        c2 = px.sqnorm_in_order(c)[None, :]
        idots = px.intdot(qx.q, cq, ([1], [1]))                # [m,k] i32
        dots = idots.float() * t[None, :]
        return torch.clamp_min((c2 - 2.0 * dots) + x2, 0.0)
    px.check(prec)
    if x2 is None:
        x2 = px.sqnorm(x, keepdim=True)
    c2 = px.sqnorm(c)[None, :]
    dots = px.dot(x, c, ([1], [1]), prec)
    d = x2 - 2.0 * dots + c2
    return torch.clamp_min(d, 0.0)


def assign_ref(x, c: torch.Tensor,
               *, precision: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: (ids int32 [m], sq_dist f32 [m]).

    Ties go to the lowest index (``torch.min`` returns the first minimum).
    """
    d = pairwise_sqdist_ref(x, c, precision=precision)
    mind, ids = torch.min(d, dim=1)
    return ids.to(torch.int32), mind


def update_ref(x, ids: torch.Tensor, k: int,
               weights: torch.Tensor | None = None,
               *, precision: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster feature sums f32 [k,n] and counts f32 [k].

    ``ids`` outside [0, k) contribute nothing (used for padding).
    ``weights`` ([m], optional) scale each row's one-hot entry, so the
    sums are weighted and the counts are the clusters' total weights.
    Under ``'int8'`` the unweighted one-hot (0/1) contracts with the codes
    in exact int32, and the int32 sums are scaled by ``scale[f]`` only
    after the whole contraction; a weighted update has non-integer
    membership and runs f32 on the dequantized codes (reference
    ``ref.py:93-96``).
    """
    prec = px.from_dtype(x.dtype) if precision is None else px.check(
        precision)
    lanes = torch.arange(k, device=ids.device, dtype=ids.dtype)
    if prec == "int8":
        qx = px.as_quantized(x)
        if weights is not None:
            return update_ref(px.dequantize(qx), ids, k, weights,
                              precision="f32")
        hit = ids[:, None] == lanes[None, :]                  # [m,k]
        isums = px.intdot(hit.to(torch.int8), qx.q, ([0], [0]))  # [k,n] i32
        sums = isums.float() * qx.scale[None, :]
        return sums, torch.sum(hit.float(), dim=0)
    onehot = (ids[:, None] == lanes[None, :]).float()         # [m,k]
    if weights is not None:
        onehot = onehot * weights.float()[:, None]
    sums = px.dot(onehot, x, ([0], [0]), prec)                # [k,n]
    counts = torch.sum(onehot, dim=0)                         # [k]
    return sums, counts


def min_update_ref(d: torch.Tensor, x: torch.Tensor,
                   c_new: torch.Tensor) -> torch.Tensor:
    """K-means++ distance relaxation: d <- min(d, ||x - c_new||^2)."""
    diff = x.float() - c_new.float()[None, :]
    return torch.minimum(d, torch.sum(diff * diff, dim=-1))
