"""`FitResult` — the result of one :func:`repro_torch.api.fit` call.

The same fields as the reference's ``repro.api.FitResult``.  ``centroids``
is a torch tensor on the device the fit ran on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class FitResult:
    """Unified result of one fit.

    * ``centroids`` — [k, n] float32 cluster centers (torch tensor).
    * ``objective`` — f(C, P) on the winning chunk (a sum over ``s`` points);
      :func:`repro_torch.api.evaluate` gives the full-data f(C, X).
    * ``strategy`` — the strategy that ran ("sequential" or "batched").
    * ``n_chunks`` / ``n_accepted`` / ``n_iterations`` — chunks processed,
      incumbent improvements, total Lloyd iterations.
    * ``n_dist_evals`` — the paper's analytic n_d counter.
    * ``trace`` — ``(chunk_idx, f_new, accepted)`` triples (round-major
      under ``batched``).
    * ``extras`` — ``extras["fit"]`` records how the fit was dispatched,
      the impl and device actually used included; ``batched`` adds
      ``batch`` and ``rounds``.
    """

    centroids: Any
    objective: float
    algorithm: str = "big_means"
    strategy: str | None = None
    n_chunks: int = 0
    n_accepted: int = 0
    n_iterations: int = 0
    n_dist_evals: float = math.nan
    wall_time_s: float = 0.0
    trace: list = dataclasses.field(default_factory=list)
    checkpoint_dir: str | None = None
    config: Any = None
    extras: dict = dataclasses.field(default_factory=dict)
