"""`repro_torch.api` — the port's entry point for Big-means clustering.

::

    from repro_torch.api import BigMeansConfig, evaluate, fit

    result = fit(X, k=25, s=64_000, n_chunks=32)        # on the CUDA device
    ids, f = evaluate(result, X)                        # full-data f(C, X)
    result = fit(X, cfg, batch=8, sync_every=2)         # 8 streams at once
    result = fit(X, cfg, method="sequential", device="cpu")
    result = fit(X, cfg, precision="int8")              # int8 Lloyd loop
    result = fit(X, cfg, precision="bf16")              # bf16 storage
    result = fit(X, cfg, precision="bf16x3")            # 3 bf16 products
    result = fit(X.bfloat16(), cfg)                     # 'auto': bf16

``fit`` runs on the CUDA device unless ``device="cpu"`` is passed, and
raises ``RuntimeError`` when no CUDA device is present and the CPU was not
asked for.  Strategies, sources and knobs that this slice does not port
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import time

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch.api import strategies as strategies
from repro_torch.api.config import BigMeansConfig
from repro_torch.api.result import FitResult
from repro_torch.api.sources import ArraySource, DataSource, MemmapSource, \
    as_source
from repro_torch.api.strategies import (
    get_strategy, list_strategies, register_strategy, resolve_auto,
)
from repro_torch.data import synthetic as synthetic
from repro_torch.kernels import ops
from repro_torch.kernels import precision as px

__all__ = [
    "ArraySource", "BigMeansConfig", "DataSource", "FitResult",
    "MemmapSource", "as_source", "evaluate", "fit", "get_strategy",
    "list_strategies", "register_strategy", "resolve_auto",
    "strategies", "synthetic",
]

# The reference's §5 baselines (repro.api.baselines).
BASELINES = ("coreset", "da_mssc", "forgy", "kmeans_parallel", "kmeanspp",
             "multistart", "ward")


def _resolve_method(method: str):
    if method in BASELINES:
        raise NotImplementedError(
            f"baseline {method!r} is not ported yet (ROADMAP queue 1 item 9)")
    return get_strategy(method)


def fit(
    data,
    config: BigMeansConfig | None = None,
    *,
    method: str = "auto",
    key=None,
    rng=None,
    device=None,
    **overrides,
) -> FitResult:
    """Cluster ``data`` and return a :class:`FitResult`.

    * ``data`` — a 2-D numpy array or torch tensor, or an ``.npy`` path.
    * ``config`` — a :class:`BigMeansConfig`; ``overrides`` are applied on
      top (or, with no config, must include at least ``k`` and ``s``).
    * ``method`` — ``'auto'``, ``'sequential'`` or ``'batched'`` (``'auto'``
      picks ``'batched'`` when ``batch > 1``).
    * ``rng`` — the key-tree backend (:class:`repro_torch.random.TorchRNG`
      by default); ``key`` defaults to ``rng.key(config.seed)``.
    * ``device`` — ``None`` runs on the CUDA device; ``'cpu'`` runs the
      plain PyTorch path on the CPU.

    ``wall_time_s`` covers the run, the kernels' build at first use
    included.
    """
    if config is None:
        missing = {"k", "s"} - set(overrides)
        if missing:
            raise TypeError(
                f"fit() without a config needs {sorted(missing)} "
                "(e.g. fit(X, k=25, s=16384))")
        cfg = BigMeansConfig(**overrides)
    else:
        cfg = config.replace(**overrides) if overrides else config
    dev = devices.resolve(device)
    source = as_source(data)
    fn = _resolve_method(method)
    rng = rnd.TORCH if rng is None else rng
    if key is None:
        key = rng.key(cfg.seed)
    t0 = time.monotonic()
    result = fn(cfg, source, key, rng=rng, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    result.wall_time_s = time.monotonic() - t0
    result.extras["fit"] = {
        "method": method,
        "impl": ops.resolve_impl(cfg.impl, dev),
        # 'auto' follows the data: bf16 for a bf16 tensor, f32 otherwise
        "precision": px.resolve(cfg.precision, source.data_dtype),
        "autotune": cfg.autotune,
        "seed": int(cfg.seed),
        "source": type(source).__name__,
        "device": str(dev),
    }
    return result


def evaluate(result_or_centroids, data, *, device=None, impl: str = "auto"
             ) -> tuple[torch.Tensor, float]:
    """Full-data evaluation: ``(assignments [m], objective f(C, X))``.

    Streams the data through ``full_assignment`` in 262,144-row batches
    (kernel B on the card).  Runs on the CUDA device unless ``device="cpu"``.
    """
    from repro_torch.core.objective import full_assignment

    dev = devices.resolve(device)
    centroids = getattr(result_or_centroids, "centroids", result_or_centroids)
    X = devices.to_f32(as_source(data).as_array(), dev)
    ids, f = full_assignment(X, torch.as_tensor(centroids), impl=impl)
    return ids, float(f)
