"""The paper's own workload as a config: Big-means on a HEPMASS-scale
stream (m=10.5M, n=27, k=25, s=64000 — the paper's largest setting).

The reference's ``repro.configs.bigmeans_paper``.  The algorithm knobs live
in one place — an embedded :class:`repro_torch.api.BigMeansConfig`
(``.algo``) — and are exposed as read-only properties, so this file cannot
drift from the facade's config.  ``BigMeansConfig.from_workload(CONFIG,
n_chunks=32)`` is the configuration ``chip_smoke.py`` fits at HEPMASS
scale with ``batch=8, sync_every=2``.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.api.config import BigMeansConfig

_PAPER_ALGO = BigMeansConfig(
    k=25,
    s=64_000,
    n_chunks=4,          # chunks per worker of a sharded run
    sync_every=2,
    batch=8,             # in-core chunk parallelism (batched strategy)
    prefetch=2,          # host runner's prefetch queue depth
)


class BigMeansWorkload:
    """Dataset descriptor + algorithm config.

    Only the dataset shape (``m``, ``n_features``) and registry identity
    (``name``, ``family``) live here; every algorithm knob is a view onto
    ``.algo``.  The legacy constructor keywords (``k=``, ``s=``,
    ``chunks_per_worker=``, ...) still work for one release behind a
    DeprecationWarning.
    """

    _LEGACY_TO_ALGO = {
        "k": "k", "s": "s", "chunks_per_worker": "n_chunks",
        "sync_every": "sync_every", "max_iters": "max_iters", "tol": "tol",
        "candidates": "candidates", "batch": "batch", "prefetch": "prefetch",
    }

    def __init__(self, name: str = "bigmeans_paper", family: str = "cluster",
                 m: int = 10_500_000, n_features: int = 27,
                 algo: BigMeansConfig | None = None, **legacy):
        self.name = name
        self.family = family
        self.m = m
        self.n_features = n_features
        unknown = set(legacy) - set(self._LEGACY_TO_ALGO)
        if unknown:
            raise TypeError(
                f"unknown BigMeansWorkload fields {sorted(unknown)}")
        if legacy:
            warnings.warn(
                "passing algorithm knobs to BigMeansWorkload is deprecated; "
                "pass algo=repro_torch.api.BigMeansConfig(...) instead",
                DeprecationWarning, stacklevel=2)
            algo = dataclasses.replace(
                algo or _PAPER_ALGO,
                **{self._LEGACY_TO_ALGO[k]: v for k, v in legacy.items()})
        self.algo = algo or _PAPER_ALGO

    # read-only views of the shared knob truth
    k = property(lambda self: self.algo.k)
    s = property(lambda self: self.algo.s)
    chunks_per_worker = property(lambda self: self.algo.n_chunks)
    sync_every = property(lambda self: self.algo.sync_every)
    max_iters = property(lambda self: self.algo.max_iters)
    tol = property(lambda self: self.algo.tol)
    candidates = property(lambda self: self.algo.candidates)
    batch = property(lambda self: self.algo.batch)
    prefetch = property(lambda self: self.algo.prefetch)

    def __repr__(self):
        return (f"BigMeansWorkload(name={self.name!r}, m={self.m}, "
                f"n_features={self.n_features}, algo={self.algo!r})")


CONFIG = BigMeansWorkload()
