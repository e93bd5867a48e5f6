"""Quality metrics of the paper's §5 comparison protocol (the reference's
``repro.evalsuite.metrics``, plain Python, unchanged).

Everything here is pure arithmetic over run records, so the suite and the
gate share one definition of every number they exchange:

* relative clustering error ``ε = (f − f*) / f*`` against the committed
  best-known objective ``f*`` (the paper's E_A, as a fraction, not %);
* success rate over seeds: the fraction of runs with ``ε <= tol``
  (the paper reports min/mean/max over executions; success rate is the
  CI-friendly scalar of the same distribution);
* run-level time-to-target curves: for a grid of wall-time budgets ``t``,
  the fraction of runs that both succeeded and finished within ``t``.
  Granularity is one point per *run* (the suite does not timestamp
  intra-run trace entries), which is exactly the paper's equal-budget
  question — "given t seconds, how often does this method reach the
  target?" — not an anytime curve.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence


def relative_error(f: float, f_star: float) -> float:
    """ε = (f − f*)/f* — negative means a new best-known objective."""
    if not (f_star and math.isfinite(f_star)):
        raise ValueError(f"f_star must be finite and non-zero, got {f_star!r}")
    return (f - f_star) / f_star


def success_rate(epsilons: Iterable[float], tol: float) -> float:
    """Fraction of runs with ε <= tol (NaN ε never succeeds)."""
    eps = list(epsilons)
    if not eps:
        raise ValueError("success_rate of zero runs is undefined")
    return sum(1 for e in eps if e <= tol) / len(eps)


def time_to_target_curve(
    runs: Sequence[tuple[float, bool]],
    grid: Sequence[float] | None = None,
) -> list[list[float]]:
    """``[[t, fraction-of-runs-succeeded-within-t], ...]`` over a time grid.

    ``runs`` is ``(wall_s, success)`` per run.  With no explicit grid, the
    curve is evaluated at each successful run's own wall time (the points
    where it actually steps), so it is exact and minimal.
    """
    if grid is None:
        grid = sorted({w for w, ok in runs if ok})
        if not grid:                       # nothing succeeded: one flat point
            grid = [max((w for w, _ in runs), default=0.0)]
    n = len(runs)
    curve = []
    for t in grid:
        frac = sum(1 for w, ok in runs if ok and w <= t) / n if n else 0.0
        curve.append([float(t), frac])
    return curve


def aggregate_cell(
    dataset: str,
    method: str,
    kind: str,
    rows: Sequence[dict],
    *,
    success_tol: float,
) -> dict:
    """One (dataset, method) cell from its per-seed rows (schema `_CELL_SCHEMA`)."""
    if not rows:
        raise ValueError(f"cell ({dataset}, {method}) has no rows")
    eps = [r["epsilon"] for r in rows]
    walls = [r["wall_s"] for r in rows]
    return {
        "dataset": dataset,
        "method": method,
        "kind": kind,
        "n_seeds": len(rows),
        "epsilon_mean": float(sum(eps) / len(eps)),
        "epsilon_min": float(min(eps)),
        "epsilon_max": float(max(eps)),
        "success_rate": success_rate(eps, success_tol),
        "wall_mean_s": float(sum(walls) / len(walls)),
        "time_to_target": time_to_target_curve(
            [(r["wall_s"], r["success"]) for r in rows]),
    }
