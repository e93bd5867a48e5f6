"""Precision policy of the kernel stack (f32 only in this slice).

The reference (``repro.kernels.precision``) knows four policies: ``'f32'``,
``'bf16'``, ``'bf16x3'`` and ``'int8'``.  The port accepts the same names;
only ``'f32'`` is ported, and the others raise ``NotImplementedError``
naming the ROADMAP item that brings them.  ``'f32'`` means true float32:
no TF32 and no reduced-precision operands anywhere.
"""
from __future__ import annotations

import torch

PRECISIONS = ("f32", "bf16", "bf16x3", "int8")

_NOT_PORTED = {
    "bf16": "ROADMAP queue 2 item 4",
    "bf16x3": "ROADMAP queue 2 item 4",
    "int8": "ROADMAP queue 2 items 6-8",
}


def check(precision: str) -> str:
    """Validate and return a concrete ``precision``.

    Unknown names raise ``ValueError``; known but unported policies raise
    ``NotImplementedError``.
    """
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; known: {PRECISIONS}")
    if precision in _NOT_PORTED:
        raise NotImplementedError(
            f"precision {precision!r} is not ported yet "
            f"({_NOT_PORTED[precision]}); only 'f32' runs")
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


def dot(a: torch.Tensor, b: torch.Tensor, dims, precision: str
        ) -> torch.Tensor:
    """Contraction ``tensordot(a, b, dims)`` under the policy, f32 result.

    ``dims`` is ``(dims_a, dims_b)``, the contracted axes — the
    ``dimension_numbers`` of the reference's ``lax.dot_general`` without
    batch axes.
    """
    check(precision)
    return torch.tensordot(a.float(), b.float(), dims=dims)


def sqnorm(a: torch.Tensor, dim=-1, keepdim: bool = False) -> torch.Tensor:
    """``sum(a*a)`` in f32 regardless of storage dtype."""
    a = a.float()
    return torch.sum(a * a, dim=dim, keepdim=keepdim)
