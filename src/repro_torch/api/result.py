"""`FitResult` — the result of one :func:`repro_torch.api.fit` call.

The same fields and methods as the reference's ``repro.api.FitResult``.
``centroids`` is a torch tensor on the device the fit ran on.
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
    * ``strategy`` — the strategy that ran ("sequential", "batched",
      "sharded" or "streaming").
    * ``n_chunks`` / ``n_accepted`` / ``n_iterations`` — chunks processed,
      incumbent improvements, total Lloyd iterations.
    * ``n_dist_evals`` — the paper's analytic n_d counter.
    * ``trace`` — ``(chunk_idx, f_new, accepted)`` triples (round-major
      under ``batched``, group-major on a stream mesh, worker-major under
      ``sharded``).  Under ``streaming``: ``(chunk_id, f_best,
      f_new)`` progress entries every ``log_every`` chunks, and the
      runner's events — ``("fetch_error", chunk_id, "ExcType: message")``,
      ``("quarantine", chunk_id, reason)``, ``("short_chunk", chunk_id,
      rows, need)``, ``("budget_drop", (chunk_ids...))``,
      ``("ckpt_fallback", step or None)``.
    * ``checkpoint_dir`` — the streaming fit's ``ckpt_dir`` (None without
      checkpoints).
    * ``extras`` — ``extras["fit"]`` records how the fit was dispatched,
      the impl and device actually used included; ``batched`` adds
      ``batch`` and ``rounds``; ``streaming`` adds ``chunks_failed``,
      ``chunks_dropped``, ``chunks_quarantined``, ``health`` (``done +
      failed + dropped + quarantined == fetched``), ``pipeline`` (the
      prefetch pipeline's per-chunk times,
      :class:`repro_torch.engine.stream.RunnerMetrics`), with
      ``ckpt_dir`` ``checkpoint`` (the save, device-read and restore ms)
      and, under
      ``scheduler="competitive_s"``, ``competitive_s`` (``ladder``,
      ``final_sizes``, ``windows``); on a host mesh ``host`` (``rank``,
      ``processes``, ``winner_rank``) and ``health["ranks"]`` (every
      rank's accounting), with the run's totals global on every rank.
      ``sharded`` adds ``workers``, ``chunks_per_worker`` and, with
      checkpoints or a time budget, ``rounds_done`` (and ``checkpoint``
      under ``ckpt_dir``).
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

    @property
    def health(self) -> dict | None:
        """The run-health summary (the streaming strategy): chunk
        accounting (``done + failed + dropped + quarantined == fetched``),
        the checkpoint fallback and the quarantine reasons.  None when the
        strategy does not stream.  The port keeps no kernel demotions, so
        it never holds ``kernel_fallbacks``."""
        return self.extras.get("health")

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_features(self) -> int:
        return self.centroids.shape[1]

    def to_row(self) -> dict:
        """A flat, JSON-safe record of this fit (the evalsuite / benchmark
        row contract — everything scalar, nothing device-resident)."""
        nd = self.n_dist_evals
        return {
            "algorithm": self.algorithm,
            "strategy": self.strategy,
            "objective": float(self.objective),
            "k": int(self.k),
            "n_features": int(self.n_features),
            "n_chunks": int(self.n_chunks),
            "n_accepted": int(self.n_accepted),
            "n_iterations": int(self.n_iterations),
            "n_dist_evals": None if math.isnan(nd) else float(nd),
            "wall_time_s": float(self.wall_time_s),
            "fit": self.extras.get("fit"),
        }

    def summary(self) -> str:
        via = f" via {self.strategy}" if self.strategy else ""
        nd = ("n_d=nan" if math.isnan(self.n_dist_evals)
              else f"n_d={self.n_dist_evals:.3e}")
        return (f"{self.algorithm}{via}: f={self.objective:.6e}  "
                f"k={self.k}  chunks={self.n_chunks}  "
                f"accepted={self.n_accepted}  iters={self.n_iterations}  "
                f"{nd}  wall={self.wall_time_s:.2f}s")
