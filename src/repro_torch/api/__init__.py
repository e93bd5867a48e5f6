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
    result = fit(X, cfg, autotune=True)                 # tuned launches
    result = fit(X, cfg, method="kmeanspp")             # a §5 baseline
    list_methods()    # ['auto', 'batched', ..., 'coreset', 'da_mssc', ...]
    result = fit("data.npy", cfg)                       # streamed from disk
    result = fit(provider, cfg, n_features=28)          # chunk_id -> [s, n]
    ids, f = evaluate(result, "data.npy")               # loads the file
    result = fit(X, cfg, method="sharded",              # 4 workers
                 topology=TopologySpec(kind="worker_mesh", devices=4))
    result = fit(X, cfg, batch=8, topology=TopologySpec(
        kind="stream_mesh", devices=4))                 # 4 stream groups
    result = fit("data.npy", cfg, topology="host_mesh") # one rank of many
    with serve({"m": result}) as srv:                   # serving, on the card
        resp = srv.assign("m", queries)                 # -> AssignResponse

``fit`` runs on the CUDA device unless ``device="cpu"`` is passed, and
raises ``RuntimeError`` when no CUDA device is present and the CPU was not
asked for.  An ``.npy`` path, a provider callable or a chunk iterator runs
the ``streaming`` strategy (:mod:`repro_torch.engine.stream`): chunks are
fetched on a worker thread and staged onto the card through pinned
buffers on a copy stream, so the data never has to fit on the device.
The paper's §5 baselines (:mod:`repro_torch.api.baselines`: ``forgy``,
``kmeanspp``, ``kmeans_parallel``, ``coreset``, ``da_mssc``, ``ward``) run
through the same ``fit`` on in-core data only; a provider or an iterator
raises ``TypeError`` there.  An unknown method raises ``KeyError``.

``topology`` places the run (:mod:`repro_torch.engine.topology`): a
worker mesh for the ``sharded`` strategy, a stream mesh for ``batched``
and ``streaming``, and ``host_mesh`` — one process per host, each
streaming its shard of the chunk ids and exchanging incumbents through a
``torch.distributed.TCPStore`` (:mod:`repro_torch.engine.hostmesh`).  A
mesh's positions are dealt round-robin over the devices of ``device``:
W workers on one card run one after another in worker order.

``autotune=True`` times the launch choices of the fit's kernels at its
shapes before it runs (:func:`_pretune`) and caches the winners
(:mod:`repro_torch.kernels.autotune`; ``REPRO_AUTOTUNE_CACHE`` keeps them
on disk).  A winner in the cache is used with or without ``autotune``:
that is how a profile is pinned.  Every choice gives bitwise the same
results.
"""
from __future__ import annotations

import time

import torch

from repro_torch import device as devices
from repro_torch import random as rnd
from repro_torch import tracing
from repro_torch.api import baselines as baselines
from repro_torch.api import strategies as strategies
from repro_torch.api.baselines import (
    get_baseline, list_baselines, register_baseline,
)
from repro_torch.api.config import BigMeansConfig
from repro_torch.api.result import FitResult
from repro_torch.api.sources import (
    ArraySource, DataSource, IteratorSource, MemmapSource, ProviderSource,
    as_source,
)
from repro_torch.api.strategies import (
    get_strategy, list_strategies, register_strategy, resolve_auto,
)
from repro_torch.data import synthetic as synthetic
from repro_torch.engine.topology import DeviceMesh, TopologySpec
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import precision as px
# The assignment-serving subsystem (see repro_torch.serve): training
# produces the centroids, serve() is how their value is realized at
# assignment time.
from repro_torch.serve import ServeConfig, Server, serve

__all__ = [
    "ArraySource", "BigMeansConfig", "DataSource", "DeviceMesh", "FitResult",
    "IteratorSource", "MemmapSource", "ProviderSource", "ServeConfig",
    "Server", "TopologySpec", "as_source", "baselines", "evaluate", "fit", "get_baseline",
    "get_strategy", "list_baselines", "list_methods", "list_strategies",
    "register_baseline", "register_strategy", "resolve_auto", "serve",
    "strategies", "synthetic",
]


def list_methods() -> list[str]:
    """Everything :func:`fit` accepts as ``method``, as the reference lists
    it."""
    return ["auto"] + list_strategies() + list_baselines()


def _resolve_method(method: str):
    if method in list_baselines():
        return get_baseline(method)
    if method in list_methods():
        return get_strategy(method)
    raise KeyError(f"unknown method {method!r}; known: {list_methods()}")


def _pretune(cfg: BigMeansConfig, source, device: torch.device) -> None:
    """Fill the autotune cache for the launches this fit will make.

    The counterpart of the reference's ``repro.api._pretune``: concrete
    tensors at the hot path's shapes — the fused step at ``[s, n]`` in the
    policy's storage, the assignment there and (under bf16 and int8, whose
    epilogue assigns at f32 on the full-width view) at f32, and the
    batched step at ``[batch, s, n]`` when ``batch > 1`` — from a
    ``torch.Generator`` seeded 0 on the card.  Only on the card, with the
    kernels: there is nothing to tune on the CPU or under a ``ref`` impl.
    As in the reference, these chunk shapes are all it tunes, whatever the
    method: a §5 baseline then runs with tuning off (the reference's run
    under ``jit``, where nothing is timed), so its full-data Lloyd takes
    the cached or default launch choice and nothing is timed at m = 10.5M.
    """
    impl = ops.resolve_impl(cfg.impl, device)
    if impl != "cuda":
        return
    prec = px.resolve(cfg.precision, source.data_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shape = (cfg.s, source.n_features)
    x = torch.randn(shape, generator=gen, device=device)
    c = torch.randn((cfg.k, shape[1]), generator=gen, device=device)
    xs = px.cast_storage(x, prec)
    ops.fused_step(xs, c, impl=impl, precision=prec)
    ops.assign(xs, c, impl=impl, precision=prec)
    if prec in ("bf16", "int8"):
        ops.assign(x, c, impl=impl, precision="f32")
    if cfg.batch > 1:
        cb = c.expand(cfg.batch, *c.shape).contiguous()
        xb = x.expand(cfg.batch, *shape).contiguous()
        xb = px.quantize_chunk(xb) if prec == "int8" \
            else px.cast_storage(xb, prec)
        ops.fused_step_batched(xb, cb, impl=impl, precision=prec)


def fit(
    data,
    config: BigMeansConfig | None = None,
    *,
    method: str = "auto",
    key=None,
    rng=None,
    device=None,
    n_features: int | None = None,
    **overrides,
) -> FitResult:
    """Cluster ``data`` and return a :class:`FitResult`.

    * ``data`` — anything :func:`as_source` accepts: a 2-D numpy array or
      torch tensor, an ``.npy`` path, a ``provider(chunk_id)`` callable, a
      chunk iterator, or a source.
    * ``config`` — a :class:`BigMeansConfig`; ``overrides`` are applied on
      top (or, with no config, must include at least ``k`` and ``s``).
    * ``method`` — ``'auto'``, ``'sequential'``, ``'batched'``,
      ``'sharded'`` or ``'streaming'`` (``'auto'`` picks ``'streaming'``
      for an ``.npy`` path, a provider or an iterator, else ``'batched'``
      when ``batch > 1``, else ``'sharded'`` on a worker mesh or when the
      run sees several devices, else ``'sequential'``; see
      :func:`repro_torch.api.strategies.resolve_auto`), or a §5 baseline
      (see :func:`list_methods`).
    * ``rng`` — the key-tree backend (:class:`repro_torch.random.TorchRNG`
      by default); ``key`` defaults to ``rng.key(config.seed)``.
    * ``device`` — ``None`` runs on the CUDA device; ``'cpu'`` runs the
      plain PyTorch path on the CPU.
    * ``n_features`` — feature count, only needed for provider / iterator
      data whose first chunk should not be probed eagerly.

    ``wall_time_s`` covers the run, the kernels' build at first use
    included, and not the pre-tuning of ``autotune=True``.  Autotune cache
    files that were ignored (corrupt, stale schema, a malformed entry) are
    appended to ``result.trace`` as their events.
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
    source = as_source(data, n_features=n_features)
    fn = _resolve_method(method)
    rng = rnd.TORCH if rng is None else rng
    if key is None:
        key = rng.key(cfg.seed)
    n_tune_events = len(autotune.events())
    prev_tuning = None
    try:
        autotune.load_disk()
        if cfg.autotune:
            # scoped to this call, exceptions included: a later fit with
            # autotune=False never times anything
            prev_tuning = autotune.enabled()
            autotune.enable(True)
            _pretune(cfg, source, dev)
            if method in list_baselines():
                autotune.enable(False)
        t0 = time.monotonic()
        with tracing.span("api.fit", dev):
            result = fn(cfg, source, key, rng=rng, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                tracing.count("host_sync.api.fit")
        result.wall_time_s = time.monotonic() - t0
    finally:
        if prev_tuning is not None:
            autotune.enable(prev_tuning)
    result.trace.extend(autotune.events()[n_tune_events:])
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

    Loads the data onto the device (an ``.npy`` path whole, as the
    reference does) and streams it through ``full_assignment`` in
    262,144-row batches (kernel B on the card).  Runs on the CUDA device
    unless ``device="cpu"``.
    """
    from repro_torch.core.objective import full_assignment

    dev = devices.resolve(device)
    centroids = getattr(result_or_centroids, "centroids", result_or_centroids)
    with tracing.span("api.evaluate", dev):
        X = devices.to_f32(as_source(data).as_array(), dev)
        ids, f = full_assignment(X, torch.as_tensor(centroids), impl=impl)
        tracing.count("host_sync.api.evaluate")
        return ids, float(f)
