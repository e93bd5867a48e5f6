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
    * ``strategy`` — the strategy that ran ("sequential", "batched" or
      "streaming").
    * ``n_chunks`` / ``n_accepted`` / ``n_iterations`` — chunks processed,
      incumbent improvements, total Lloyd iterations.
    * ``n_dist_evals`` — the paper's analytic n_d counter.
    * ``trace`` — ``(chunk_idx, f_new, accepted)`` triples (round-major
      under ``batched``).  Under ``streaming``: ``(chunk_id, f_best,
      f_new)`` progress entries every ``log_every`` chunks, and the
      runner's events — ``("fetch_error", chunk_id, "ExcType: message")``,
      ``("quarantine", chunk_id, reason)``, ``("short_chunk", chunk_id,
      rows, need)``.
    * ``extras`` — ``extras["fit"]`` records how the fit was dispatched,
      the impl and device actually used included; ``batched`` adds
      ``batch`` and ``rounds``; ``streaming`` adds ``chunks_failed``,
      ``chunks_dropped``, ``chunks_quarantined``, ``health`` (``done +
      failed + dropped + quarantined == fetched``) and ``pipeline`` (the
      prefetch pipeline's per-chunk times,
      :class:`repro_torch.engine.stream.RunnerMetrics`).
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
