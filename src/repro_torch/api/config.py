"""`BigMeansConfig` — one validated dataclass for every algorithm knob.

The same fields, defaults and validation as the reference's
``repro.api.BigMeansConfig``.  What this slice of the port does not run
raises ``NotImplementedError`` here, naming the ROADMAP item that brings it,
so that no knob is silently ignored:

* ``topology`` other than ``'auto'``/``'single'`` and ``mesh`` —
  ``'stream_mesh'`` included, so a batched fit runs its streams on one
  device — (queue 1 item 8).

The streaming runner's own knobs (``prefetch``, ``log_every``,
``retries``, ``retry_backoff_s``, ``fetch_timeout_s``,
``validate_chunks``, and the checkpoints' ``ckpt_dir``, ``ckpt_every``
and ``resume``) are ported with the streaming strategy, and its
middleware and schedulers with them: ``time_budget_s`` (the paper's
``cpu_max`` stop), ``vns_ladder`` / ``vns_patience`` (the §6 chunk-size
ladder) and ``scheduler`` — ``'uniform'``, ``'worker'`` (uniform in the
stream loop) and ``'competitive_s'`` with ``competitive_ladder`` (the
sample-size race of arXiv:2403.18766).  Each of these runs the
``streaming`` strategy (``auto`` picks it, an in-core array included).

``autotune=True`` tunes the launch choices of the fit's kernels on the
card before it runs (:mod:`repro_torch.kernels.autotune`: kernel A's
pipeline, kernel B's CTAs per SM) and caches the winners; every choice
gives bitwise the same results, so the fit does too.  On the CPU there is
nothing to tune.

``precision`` takes the reference's four policies, ``'f32'``, ``'bf16'``
(bf16 storage and bf16 products), ``'bf16x3'`` (f32 storage, three bf16
products per contraction) and ``'int8'``, and ``'auto'``, which resolves
against the data's dtype at fit time (``'bf16'`` for a ``torch.bfloat16``
tensor, ``'f32'`` otherwise).

``impl`` takes the port's kernel impls: ``'auto'``, ``'cuda'``, ``'ref'``,
``'ref_chunked'`` (see :mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.kernels import ops
from repro_torch.kernels import precision as px

SCHEDULERS = ("competitive_s", "uniform", "worker")
TOPOLOGY_KINDS = ("auto", "single", "stream_mesh", "worker_mesh",
                  "host_mesh")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item {item})")


@dataclasses.dataclass(frozen=True)
class BigMeansConfig:
    """Validated configuration for one Big-means fit (see the reference's
    docstring for the meaning of each knob)."""

    k: int
    s: int
    n_chunks: int = 100
    max_iters: int = 300
    tol: float = 1e-4
    candidates: int = 3
    impl: str = "auto"
    precision: str = "auto"
    autotune: bool = False
    with_replacement: bool = True
    # --- parallel execution
    batch: int = 1
    sync_every: int = 1
    sync: str = "auto"
    scheduler: str = "uniform"
    competitive_ladder: tuple = ()
    topology: Any = "auto"
    mesh: Any = None
    mesh_axes: tuple = ("data",)
    stream_axis: str = "streams"
    # --- streaming runner
    prefetch: int = 2
    time_budget_s: float | None = None
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    resume: bool = True
    log_every: int = 50
    seed: int = 0
    vns_ladder: tuple = ()
    vns_patience: int = 10
    # --- fault tolerance
    retries: int = 0
    retry_backoff_s: float = 0.05
    fetch_timeout_s: float | None = None
    validate_chunks: bool = True

    def __post_init__(self):
        def _positive(name, value):
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 1:
                raise ValueError(
                    f"{name} must be a positive int, got {value!r}")

        for name in ("k", "s", "n_chunks", "max_iters", "candidates", "batch",
                     "sync_every", "ckpt_every", "vns_patience"):
            _positive(name, getattr(self, name))
        if self.s < self.k:
            raise ValueError(
                f"chunk size s={self.s} must be >= k={self.k}: K-means++ "
                "cannot seed k centers from fewer than k points")
        if self.tol < 0:
            raise ValueError(f"tol must be >= 0, got {self.tol!r}")
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch!r}")
        if self.log_every < 0:
            raise ValueError(f"log_every must be >= 0, got {self.log_every!r}")
        if self.time_budget_s is not None and self.time_budget_s <= 0:
            raise ValueError(
                f"time_budget_s must be positive, got {self.time_budget_s!r}")
        if not isinstance(self.retries, int) \
                or isinstance(self.retries, bool) or self.retries < 0:
            raise ValueError(
                f"retries must be an int >= 0, got {self.retries!r}")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s!r}")
        if self.fetch_timeout_s is not None and self.fetch_timeout_s <= 0:
            raise ValueError(
                f"fetch_timeout_s must be positive, got "
                f"{self.fetch_timeout_s!r}")
        if not isinstance(self.validate_chunks, bool):
            raise ValueError(
                f"validate_chunks must be a bool, got "
                f"{self.validate_chunks!r}")
        if self.impl != "auto" and self.impl not in ops.IMPLS:
            raise ValueError(
                f"unknown impl {self.impl!r}; known: ('auto',) + {ops.IMPLS}")
        if self.precision != "auto":
            px.check(self.precision)
        if not isinstance(self.autotune, bool):
            raise ValueError(
                f"autotune must be a bool, got {self.autotune!r}")
        for rung in self.vns_ladder:
            if not isinstance(rung, int) or rung < self.k:
                raise ValueError(
                    f"vns_ladder entries must be ints >= k, got {rung!r}")
        if self.sync not in ("auto", "collective", "periodic", "competitive"):
            raise ValueError(
                f"unknown sync mode {self.sync!r}; known: auto, collective, "
                "periodic, competitive")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; known: "
                f"{list(SCHEDULERS)}")
        for rung in self.competitive_ladder:
            if not isinstance(rung, int) or rung < self.k:
                raise ValueError(
                    f"competitive_ladder entries must be ints >= k, "
                    f"got {rung!r}")
        if self.scheduler == "competitive_s" and self.batch < 2:
            raise ValueError(
                "scheduler='competitive_s' races streams against each "
                f"other; it needs batch >= 2, got batch={self.batch}")
        kind = getattr(self.topology, "kind", self.topology)
        if kind not in TOPOLOGY_KINDS:
            raise ValueError(
                f"unknown topology kind {kind!r}; known: {TOPOLOGY_KINDS}")
        self._check_ported(kind)

    def _check_ported(self, kind: str) -> None:
        if kind not in ("auto", "single") or self.mesh is not None:
            raise _not_ported(
                f"topology={kind!r} / mesh (multi-device runs)", "8")

    def replace(self, **overrides) -> "BigMeansConfig":
        """A copy with ``overrides`` applied (re-validated)."""
        return dataclasses.replace(self, **overrides)
