"""One AdamW step replayed in float64, to hold two steps to each other.

Two train steps on the same parameters (the port's and the reference's,
or the card's and the CPU's) take gradients that differ in their last
bits, and AdamW divides each moment by the root of the second: where a
gradient is near zero its update can move by up to 2 lr.  So a step is
held through its gradients, and its new parameters within the gap that
AdamW itself puts between those gradients' updates:
:func:`step_gap_bound` replays the step on each side's gradients in
float64 (:func:`adamw_replay`) and adds what f32 rounding can add.
"""
from __future__ import annotations

import numpy as np

F32_ULP = 2.0 ** -23      # f32's spacing at 1.0
UPDATE_RTOL = 1e-5        # f32 rounding of one element's update (a few
#                           ulps of m, v, sqrt and the division)


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, np.float64)


def adamw_replay(params: dict, grads: dict, mu: dict, nu: dict, step: int,
                 lr: float, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float | None = 1.0) -> dict:
    """{name: new value} of one AdamW step (the reference's arithmetic) in
    float64, from the moments ``mu`` / ``nu`` after ``step - 1`` steps."""
    g = {k: _np(v) for k, v in grads.items()}
    if grad_clip is not None:
        gnorm = np.sqrt(sum(np.sum(v * v) for v in g.values()))
        scale = min(1.0, grad_clip / max(gnorm, 1e-12))
        g = {k: v * scale for k, v in g.items()}
    b1t, b2t = 1.0 - b1 ** step, 1.0 - b2 ** step
    out = {}
    for k, p in params.items():
        p = _np(p)
        m = b1 * _np(mu[k]) + (1 - b1) * g[k]
        v = b2 * _np(nu[k]) + (1 - b2) * g[k] * g[k]
        delta = (m / b1t) / (np.sqrt(v / b2t) + eps) + weight_decay * p
        out[k] = p - lr * delta
    return out


def step_gap_bound(params: dict, grads_a: dict, grads_b: dict, mu: dict,
                   nu: dict, step: int, lr: float, **kw) -> dict:
    """{name: per-element bound on |new_a - new_b|}: the float64 gap
    between the steps on ``grads_a`` and ``grads_b`` from the same
    parameters and moments, plus each side's f32 rounding (an update off
    by ``UPDATE_RTOL`` of its size, the new value by an ulp)."""
    a = adamw_replay(params, grads_a, mu, nu, step, lr, **kw)
    b = adamw_replay(params, grads_b, mu, nu, step, lr, **kw)
    wd = kw.get("weight_decay", 0.1)
    out = {}
    for k, p in params.items():
        p = np.abs(_np(p))
        slack = 2 * (F32_ULP * (p + lr * (1 + wd * p))
                     + lr * UPDATE_RTOL * (1 + wd * p))
        out[k] = np.abs(a[k] - b[k]) + slack
    return out
