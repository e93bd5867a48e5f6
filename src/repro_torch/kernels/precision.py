"""Precision policy of the kernel stack: ``'f32'``, ``'bf16'``,
``'bf16x3'`` and ``'int8'``, the reference's four
(``repro.kernels.precision``).

``'f32'`` means true float32: no TF32 and no reduced-precision operands
anywhere.

``'bf16'`` stores the chunk as bfloat16 (half the bytes) and contracts
bf16 x bf16 with f32 accumulation.  A bf16 product is exact in f32, so
:func:`dot` rounds both operands to bf16 (round-to-nearest-even, as
``astype(bfloat16)``), widens them and contracts in f32: the MXU's
arithmetic up to the order of the sums.  Norms, sums, counts and the
objective stay f32.

``'bf16x3'`` keeps f32 storage and runs every contraction as three bf16
products ``dot(hi_a, hi_b) + dot(hi_a, lo_b) + dot(lo_a, hi_b)`` with
``hi = bf16(a)`` and ``lo = bf16(a - hi)``, added in that order.  Under it
the one-hot of the update has no low part, so its sums are
``sum(x_hi) + sum(x_lo)``, not the f32 sums.

``'int8'`` is the reference's scheme, bit for bit:

* chunk side (once per chunk, at Lloyd entry): per-feature scales
  ``s[f] = max_m |x[m, f]| / 127`` (floored at ``_SCALE_FLOOR``) and codes
  ``xq = round(x / s)`` clamped to [-127, 127];
* centroid side (per Lloyd iteration): ``cs = c * s``, per-row scales
  ``t[j] = max_f |cs[j, f]| / 127`` and codes ``cq = round(cs / t)``;
* ``x . c_j ~= (sum_f xq cq_j) * t[j]``, an exact int32 contraction, with
  the f32 correction terms ``||c||^2`` (full-width centroids) and
  ``||x||^2`` (dequantized codes).

Rounding is half-to-even (``torch.round``, as ``jnp.round``), scales divide
with ``/`` (never a multiplied reciprocal) and codes are clamped before the
int8 cast, so quantization here is bitwise the reference's.  The accepting
objective never goes through the quantized contraction: the Lloyd loops
keep a full-width view for the epilogue (``core/kmeans.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PRECISIONS = ("f32", "bf16", "bf16x3", "int8")

INT8_MAX = 127.0

# Smallest admissible quantization scale: guards the x / s division against
# all-zero features without perturbing any real scale.
_SCALE_FLOOR = 1e-30

def check(precision: str) -> str:
    """Validate and return a concrete ``precision`` (unknown names raise
    ``ValueError``)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; known: {PRECISIONS}")
    return precision


def from_dtype(dtype) -> str:
    """The precision a raw tensor dtype implies (dtype-driven ``'auto'``)."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.int8:
        return "int8"
    return "f32"


def resolve(precision: str | None, dtype) -> str:
    """Resolve a precision knob against the data dtype (``'auto'`` / None
    follow the data, as in the reference); the result is checked."""
    if precision is None or precision == "auto":
        return check(from_dtype(dtype))
    return check(precision)


def storage_dtype(precision: str) -> torch.dtype:
    """The dtype chunk data is stored in under a concrete policy (for
    ``'int8'`` the code dtype of a :class:`QuantizedChunk`)."""
    return {"bf16": torch.bfloat16, "int8": torch.int8}.get(
        check(precision), torch.float32)


def cast_storage(x, precision: str | None):
    """Data in its storage form under ``precision`` (auto-aware): a
    :class:`QuantizedChunk` for ``'int8'`` (a quantized chunk passes
    through unchanged), bf16 for ``'bf16'``, f32 otherwise."""
    if isinstance(x, QuantizedChunk):
        return x
    prec = resolve(precision, x.dtype)
    if prec == "int8":
        return quantize_chunk(x)
    return x.to(storage_dtype(prec))


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 (nearest, ties to even), as f32 values."""
    return a.to(torch.bfloat16).float()


def _split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = bf16(a)`` and ``lo = bf16(a - hi)``, as
    f32 values (reference ``precision._split_bf16``)."""
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def dot(a: torch.Tensor, b: torch.Tensor, dims, precision: str
        ) -> torch.Tensor:
    """Contraction ``tensordot(a, b, dims)`` under the policy, f32 result.

    ``dims`` is ``(dims_a, dims_b)``, the contracted axes — the
    ``dimension_numbers`` of the reference's ``lax.dot_general`` without
    batch axes.  The bf16 operands are contracted as the f32 values they
    hold: their products are exact in f32.  As in the reference there is
    no generic int8 path: the scale algebra is contraction-specific
    (:func:`intdot`).
    """
    prec = check(precision)
    if prec == "int8":
        raise ValueError(
            "dot has no generic int8 path: use quantize_chunk / "
            "quantize_centroids / intdot (see the ref.py oracles)")
    a, b = a.float(), b.float()
    if prec == "f32":
        return torch.tensordot(a, b, dims=dims)
    if prec == "bf16":
        return torch.tensordot(_bf16(a), _bf16(b), dims=dims)
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    return (torch.tensordot(ah, bh, dims=dims)
            + torch.tensordot(ah, bl, dims=dims)
            + torch.tensordot(al, bh, dims=dims))


def sqnorm(a: torch.Tensor, dim=-1, keepdim: bool = False) -> torch.Tensor:
    """``sum(a*a)`` in f32 regardless of storage dtype."""
    a = a.float()
    return torch.sum(a * a, dim=dim, keepdim=keepdim)


XLA_WINDOW = 32   # XLA's CPU reductions sum windows of this many values


def sqnorm_in_order(a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``sum(a*a)`` over the last axis in f32, in the order in which XLA
    sums it on the CPU: the order of the kernels' norms
    (``common.cuh:XlaSum``) and of the reference's, bitwise.  The int8
    scores turn on these norms: an ulp in ``||c||^2`` flips a near-tie
    point, and int8 Lloyd, whose objective need not settle within the
    tolerance, then runs a different number of iterations.

    XLA rewrites a reduction of more than 32 values into sums of windows
    of 32 and a reduction of the window sums, recursively.  The row is
    first padded with zeros to a multiple of 32, half the padding
    (rounded down) before the values and the rest after; each window is
    summed in index order from 0, and so is the last level (32 values or
    fewer; for n <= 32 the features one by one)."""
    sq = a.float() * a.float()
    while sq.shape[-1] > XLA_WINDOW:
        pad = -sq.shape[-1] % XLA_WINDOW
        sq = torch.nn.functional.pad(sq, (pad // 2, pad - pad // 2))
        sq = _sum_in_order(sq.unflatten(-1, (-1, XLA_WINDOW)))
    acc = _sum_in_order(sq)
    return acc[..., None] if keepdim else acc


def _sum_in_order(v: torch.Tensor) -> torch.Tensor:
    """The last axis of ``v`` added in index order from 0."""
    acc = torch.zeros_like(v[..., 0])
    for f in range(v.shape[-1]):
        acc = acc + v[..., f]
    return acc


# ---------------------------------------------------------------------------
# int8 quantization scheme (reference precision.py:173-281)
# ---------------------------------------------------------------------------


class QuantizedChunk(NamedTuple):
    """An int8-quantized chunk: codes plus per-feature scales.

    ``q`` is int8 ``[..., m, n]``; ``scale`` is f32 ``[..., n]`` (one scale
    per feature; batched chunks carry one scale row per stream).
    """

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device


def feature_scales(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Per-feature quantization scales ``max|x| / 127`` over the points
    axis."""
    absmax = torch.amax(torch.abs(x.float()), dim=dim)
    return torch.clamp_min(absmax / INT8_MAX, _SCALE_FLOOR)


def quantize_chunk(x: torch.Tensor) -> QuantizedChunk:
    """Quantize a chunk ``[..., m, n]`` to int8 codes + per-feature
    scales."""
    x = x.float()
    scale = feature_scales(x)                                 # [..., n]
    q = torch.clamp(torch.round(x / scale[..., None, :]), -INT8_MAX,
                    INT8_MAX)
    return QuantizedChunk(q.to(torch.int8), scale)


def as_quantized(x) -> QuantizedChunk:
    """Coerce a chunk to its quantized form (idempotent)."""
    return x if isinstance(x, QuantizedChunk) else quantize_chunk(x)


def dequantize(qx: QuantizedChunk) -> torch.Tensor:
    """The f32 values the int8 contraction actually sees."""
    return qx.q.float() * qx.scale[..., None, :]


def quantize_centroids(c: torch.Tensor, scale: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize centroids ``[..., k, n]`` into the chunk's scaled feature
    space (``scale`` ``[..., n]``): ``(cq int8 [..., k, n], t f32 [..., k])``
    with ``c[j] . x[m] ~= (cq[j] . xq[m]) * t[j]``.  A leading batch axis
    quantizes each stream against its own scale row."""
    cs = c.float() * scale[..., None, :]                      # scaled space
    t = torch.clamp_min(torch.amax(torch.abs(cs), dim=-1) / INT8_MAX,
                        _SCALE_FLOOR)
    cq = torch.clamp(torch.round(cs / t[..., None]), -INT8_MAX, INT8_MAX)
    return cq.to(torch.int8), t


def intdot(a: torch.Tensor, b: torch.Tensor, dims) -> torch.Tensor:
    """int8 x int8 ``tensordot(a, b, dims)`` as exact int32.

    On the CPU the contraction runs in int32; CUDA has no int32 matmul, so
    there it runs in float64, which is exact for ``|sum| < 2**53`` (any
    feature width here: a product is at most 127**2) before the int32
    cast.  The plain versions use this; the kernels accumulate in int32.
    """
    if a.device.type == "cpu":
        return torch.tensordot(a.to(torch.int32), b.to(torch.int32),
                               dims=dims)
    return torch.tensordot(a.double(), b.double(), dims=dims).to(torch.int32)


def host_quantize(arr) -> tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`quantize_chunk`: ``(q int8 [..., m, n], scale
    f32 [..., n])`` with the same round-half-to-even semantics, bitwise
    equal to the tensor path."""
    arr = np.asarray(arr, dtype=np.float32)
    scale = np.maximum(np.abs(arr).max(axis=-2) / INT8_MAX, _SCALE_FLOOR)
    scale = scale.astype(np.float32)
    q = np.clip(np.round(arr / scale[..., None, :]), -INT8_MAX, INT8_MAX)
    return q.astype(np.int8), scale
