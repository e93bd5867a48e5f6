"""`BigMeansConfig` — one validated dataclass for every algorithm knob.

The same fields, defaults and validation as the reference's
``repro.api.BigMeansConfig``.

``topology`` is normalized to a
:class:`repro_torch.engine.topology.TopologySpec` (a kind name or a
spec): ``'single'``, ``'stream_mesh'`` (the batched streams split into
groups over a device mesh), ``'worker_mesh'`` (the ``sharded`` strategy's
workers) and ``'host_mesh'`` (one process per host,
:mod:`repro_torch.engine.hostmesh`).  The deprecated raw ``mesh`` takes a
:class:`repro_torch.engine.topology.DeviceMesh`: it warns, is wrapped into
the equivalent topology (bitwise the spec path) and is mutually exclusive
with an explicit ``topology``.  ``mesh_axes`` is the legacy axis-name knob
of the ``sharded`` strategy.

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
:meth:`BigMeansConfig.resolved_impl` takes the device the impl resolves
for, because the port's resolver needs one (the reference's probes its
default backend).  :meth:`BigMeansConfig.from_workload` reads a
workload descriptor (:mod:`repro_torch.configs.bigmeans_paper`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import device as devices
from repro_torch.kernels import ops
from repro_torch.kernels import precision as px

SCHEDULERS = ("competitive_s", "uniform", "worker")


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
        from repro_torch.engine import topology as topo_lib

        # normalize to a frozen TopologySpec (validates kind and fields
        # once, here, so every strategy downstream can trust the spec)
        object.__setattr__(self, "topology", topo_lib.as_spec(self.topology))
        if self.mesh is not None:
            if self.topology.kind != "auto":
                raise ValueError(
                    "cfg.mesh (deprecated) and cfg.topology are mutually "
                    "exclusive; drop the raw mesh and describe it with "
                    f"topology= (got topology={self.topology.kind!r})")
            if not isinstance(self.mesh, topo_lib.DeviceMesh):
                raise TypeError(
                    "cfg.mesh takes a repro_torch.engine.topology.DeviceMesh"
                    f", got {type(self.mesh).__name__}")
            import warnings

            warnings.warn(
                "BigMeansConfig(mesh=...) is deprecated: pass a declarative "
                "topology= spec (e.g. topology='stream_mesh' or "
                "TopologySpec(kind='worker_mesh', devices=4)); the raw mesh "
                "is wrapped into the equivalent topology for now",
                DeprecationWarning, stacklevel=3)

    def replace(self, **overrides) -> "BigMeansConfig":
        """A copy with ``overrides`` applied (re-validated)."""
        return dataclasses.replace(self, **overrides)

    def resolved_impl(self, device=None) -> str:
        """The concrete kernel implementation this config runs on
        ``device``: the card unless ``"cpu"`` (``'cuda'`` there under
        ``'auto'``, ``'ref'`` on the CPU).  Raises without a card unless
        the CPU is asked for."""
        return ops.resolve_impl(self.impl, devices.resolve(device))

    @classmethod
    def from_workload(cls, workload, **overrides) -> "BigMeansConfig":
        """Derive a config from a workload descriptor.

        New-style workloads
        (:class:`repro_torch.configs.bigmeans_paper.BigMeansWorkload`)
        carry their knobs as an embedded ``.algo`` config, which is
        returned (with ``overrides`` applied).  Legacy duck-typed
        workloads are read field by field (``chunks_per_worker`` maps to
        ``n_chunks``).
        """
        algo = getattr(workload, "algo", None)
        if isinstance(algo, cls):
            return algo.replace(**overrides) if overrides else algo
        fields = dict(
            k=workload.k,
            s=workload.s,
            n_chunks=getattr(workload, "chunks_per_worker", 100),
            sync_every=getattr(workload, "sync_every", 1),
            max_iters=getattr(workload, "max_iters", 300),
            tol=getattr(workload, "tol", 1e-4),
            candidates=getattr(workload, "candidates", 3),
            batch=getattr(workload, "batch", 1),
            prefetch=getattr(workload, "prefetch", 2),
            precision=getattr(workload, "precision", "auto"),
        )
        fields.update(overrides)
        return cls(**fields)
