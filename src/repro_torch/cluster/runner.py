"""Host-streaming Big-means entry point — a thin assembly of engine pieces.

The out-of-core accept loop (prefetch pipeline, fault tolerance, VNS,
checkpoints, time budget) lives in :mod:`repro_torch.engine.stream`; this
module keeps the reference's historical entry point: :func:`run` builds the
config-derived middleware stack, scheduler and sync policy and delegates.
The names ``RunnerMetrics``, ``EndOfStream`` and ``ChunkProvider`` are
re-exported.
"""
from __future__ import annotations

from typing import Callable

from repro_torch import random as rnd
from repro_torch.core import bigmeans
from repro_torch.engine.stream import (  # noqa: F401  (re-exports)
    ChunkProvider,
    EndOfStream,
    RunnerMetrics,
    run_stream,
)


def run(
    provider: ChunkProvider,
    cfg,
    *,
    n_features: int,
    resume: bool = True,
    fault_injector: Callable[[int], None] | None = None,
    key=None,
    rng=rnd.TORCH,
    device=None,
) -> tuple[bigmeans.BigMeansState, RunnerMetrics]:
    """Stream chunks through Big-means until the chunk count or the time
    budget.

    ``cfg`` is a :class:`repro_torch.api.BigMeansConfig` (or anything with
    the same fields).
    The middleware (checkpoint, VNS, budget, tracing, fetch skip, chunk
    sanitizer and invariant guard), the scheduler and the sync policy come
    from the config.  ``fault_injector(cid)`` (raises to fail a fetch) is
    the legacy injection hook; :class:`repro_torch.engine.faults.FaultPlan`
    is the general harness.  ``rng`` is the key-tree backend and ``device``
    the device (the CUDA card unless ``"cpu"``), as in
    :func:`repro_torch.engine.stream.run_stream`.
    """
    return run_stream(
        provider, cfg, n_features=n_features, resume=resume,
        fault_injector=fault_injector, key=key, rng=rng, device=device)
