"""Public wrappers around the K-means kernels (the reference's ``ops.py``).

Dispatch policy
---------------
* ``'cuda'``        — the hand-written CUDA kernels; CUDA tensors only.
* ``'ref'``         — the plain PyTorch oracles of :mod:`.ref`, on whatever
                      device the tensors are on.
* ``'ref_chunked'`` — the oracle over row blocks of ``chunk`` rows (bounds
                      the [m, k] distance working set for big m).
* ``'auto'``        — ``'cuda'`` for a CUDA tensor, ``'ref'`` for a CPU one.

There is no demotion and no fallback: a kernel that fails to build or to
launch raises.  (The reference demotes a failing Pallas launch to its
oracle once per shape and reports it as ``("kernel_fallback", ...)``; the
port keeps the raise as a stated departure, so the reference's
``tests/test_faults.py::test_kernel_failure_demotes_once_and_falls_back``
and ``::test_kernel_fallback_surfaces_on_fit_result`` have no mirror.
``repro_torch.engine.faults.kernel_failure`` swaps the wrappers of
``_KERNELS`` to show it; serving's :func:`warm_assign` raises likewise.)
Outside the fused envelope, ``fused_step`` takes the two-pass route
through kernels B and C on the card (through the oracles under the ref
impls), and ``fused_step_batched`` takes it stream by stream.  Each kernel
wrapper counts its launches; read them with :func:`launch_counts`, zero
them with :func:`reset_launch_counts`, and add a CUDA graph's replays with
:func:`add_launch_counts`.

``precision`` follows :mod:`.precision`: all four policies are ported.  A
:class:`~.precision.QuantizedChunk` input is int8 whatever the knob says.
Each policy has its bodies of kernels A, B, C and D on the card (int8: A8,
B8, C8, D8; ``'bf16'``: A16, B16, C16, D16; ``'bf16x3'``: A3, B3, C3, D3),
and the ``'cuda'`` route casts x to the policy's storage before the kernel,
as the reference's Pallas wrappers do; the ``'ref'`` routes run the
oracles on x as given, as the reference's do (for an f32 chunk at
``'bf16'`` the two differ: the oracle takes ``||x||^2`` from the f32
values).  Outside the fused envelope the two-pass route on the card
(kernels B and C at the policy: B + C, B8 + C8, B16 + C16, B3 + C3)
departs from the reference under every policy: the reference's Pallas
impls fall back to their jnp oracle there, whatever the precision
(``repro/kernels/ops.py:327-336``), and launch Pallas only in the
epilogue's ``assign`` / ``update``.  The results are the same computation
up to the order of the sums, held to the oracles in ``chip_smoke.py`` and
the ``cuda`` tests.  The update kernels stay on the route because they
beat their plain versions there (their sorted scatter); so do the assign
kernels B8, B16 and B3 (``wgmma`` products on the tensor cores), and
kernel B, true fp32 on the CUDA cores (a register-tiled product, bitwise
the body it replaced), runs about as fast as its plain version there
(``PERF.md`` §6 row 4).

A weighted step (the §5 baselines' coresets and pools) takes the two-pass
route on every device, as in the reference (``ops.py:309``), but its
assignment on the card is kernel B at the policy, where the reference's
fallback runs its oracle (``ops.py:331``): the two-pass decision above,
carried to weights, since a plain assign would be a plain version on the
path.  Its sums and counts are the weighted contraction of
:func:`.ref.update_ref` on every device (the reference computes it outside
any Pallas kernel, ``ops.py:260-261``).

On the card every launch asks the autotuner (:mod:`.autotune`) for its
launch choice — ``fused_step`` its pipeline (kernel A or A-dma),
``assign`` its CTAs per SM, ``fused_step_batched`` kernel D's default —
with a bench that launches the kernel and synchronises the device, as the
reference's ``_bench`` does (``repro/kernels/ops.py:149-159``).  Every
choice gives bitwise the same outputs.  Tensors on the CPU never consult
it.
"""
from __future__ import annotations

import functools
import threading
from functools import partial

import torch

from repro_torch import device as devices
from repro_torch.kernels import autotune, distance, ref
from repro_torch.kernels import fused_step as fused
from repro_torch.kernels import kpp_probe as kpp
from repro_torch.kernels import precision as px
from repro_torch.kernels import update as upd

IMPLS = ("cuda", "ref", "ref_chunked")

# (name prefix, per-policy launch counts) of the bf16 / bf16x3 bodies
_COUNTS16 = (("fused_step", fused.launches16),
             ("fused_step_batched", fused.batched_launches16),
             ("assign", distance.launches16), ("update", upd.launches16))

# The kernel wrappers of each policy, by entry point.
_KERNELS = {
    "f32": dict(fused=fused.fused_step_f32,
                batched=fused.fused_step_batched_f32,
                assign=distance.assign_f32, update=upd.update_f32),
    "int8": dict(fused=fused.fused_step_int8,
                 batched=fused.fused_step_batched_int8,
                 assign=distance.assign_int8, update=upd.update_int8),
    **{prec: dict(fused=partial(fused.fused_step_16, precision=prec),
                  batched=partial(fused.fused_step_batched_16,
                                  precision=prec),
                  assign=partial(distance.assign_16, precision=prec),
                  update=partial(upd.update_16, precision=prec))
       for prec in ("bf16", "bf16x3")},
}


def _counters() -> list[tuple]:
    """``(name, holder, key)`` of every launch counter: ``holder`` is the
    kernel module whose attribute ``key`` counts, or a per-policy dict."""
    rows = [("fused_step", fused, "launches"),
            ("assign", distance, "launches"), ("update", upd, "launches"),
            ("fused_step_batched", fused, "batched_launches"),
            ("fused_step_int8", fused, "int8_launches"),
            ("fused_step_batched_int8", fused, "batched_int8_launches"),
            ("assign_int8", distance, "int8_launches"),
            ("update_int8", upd, "int8_launches"),
            ("kpp_probe", kpp, "launches"),
            ("kpp_draw", kpp, "draw_launches")]
    for name, per_policy in _COUNTS16:
        rows += [(f"{name}_{p}", per_policy, p) for p in per_policy]
    rows += [("fused_step_dma" + ("" if p == "f32" else f"_{p}"),
              fused.dma_launches, p) for p in fused.dma_launches]
    return rows


def _get(holder, key) -> int:
    return holder[key] if isinstance(holder, dict) else getattr(holder, key)


def _set(holder, key, value: int) -> None:
    if isinstance(holder, dict):
        holder[key] = value
    else:
        setattr(holder, key, value)


# The counter of each policy's assign kernel (B, B8, B16, B3).
ASSIGN_COUNTERS = {"f32": "assign", "int8": "assign_int8",
                   "bf16": "assign_bf16", "bf16x3": "assign_bf16x3"}

_count_lock = threading.RLock()
# What add_launch_counts added (the serving registry's replays, its
# captures taken back), kept apart from the wrappers' own counters: an add
# on the batcher's thread then never writes a counter that a wrapper on
# another thread (a fit's) increments, and no increment is lost between
# the add's read and its write.
_added: dict[str, int] = {}


def counts_held():
    """The counters' lock, as a context manager: while one thread holds
    it, no other adds to the counters through :func:`add_launch_counts` or
    resets them (the serving registry captures, and takes the capture's
    count back, under it)."""
    return _count_lock


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, per kernel."""
    with _count_lock:
        return {name: _get(holder, key) + _added.get(name, 0)
                for name, holder, key in _counters()}


def reset_launch_counts() -> None:
    with _count_lock:
        for _, holder, key in _counters():
            _set(holder, key, 0)
        _added.clear()


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` ({counter name: launches}) to the counters.

    A kernel wrapper counts where it runs, so under a CUDA graph it counts
    the capture, which launches nothing, and not the replays, which do:
    the serving registry takes the capture's count back and adds each
    replay's here (``serve/registry.py``).
    """
    names = {name for name, _, _ in _counters()}
    with _count_lock:
        for name, value in delta.items():
            if name not in names:
                raise KeyError(name)
            _added[name] = _added.get(name, 0) + value


def resolve_precision(precision: str | None, x) -> str:
    """The concrete policy for chunk ``x``: ``'int8'`` for a
    :class:`~.precision.QuantizedChunk`, else the knob resolved against the
    data's dtype (:func:`.precision.resolve`)."""
    if isinstance(x, px.QuantizedChunk):
        return "int8"
    return px.resolve(precision, x.dtype)


@functools.lru_cache(maxsize=None)
def tune_backend(device: torch.device) -> str:
    """The autotune cache's backend for a card: ``cuda-sm_<major><minor>``."""
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda-sm_{major}{minor}"


def _tuned(kind: str, launch, x, b: int, k: int, precision: str):
    """``launch(**choice)`` with the tuner's choice for this launch (the
    tuner times each candidate's launch by CUDA events)."""
    def bench(blocks):
        return lambda: launch(**blocks)

    m, n = x.shape[-2], x.shape[-1]
    blocks = autotune.get_blocks(kind, bench, backend=tune_backend(x.device),
                                 b=b, m=m, k=k, n=n, precision=precision)
    return launch(**blocks)


def resolve_impl(impl: str | None, device: torch.device) -> str:
    """Resolve an ``impl`` knob for tensors on ``device``.

    ``'auto'``/None -> ``'cuda'`` on a CUDA device, ``'ref'`` elsewhere.
    ``'cuda'`` for a CPU device raises: the kernels need the card.
    """
    if impl is None or impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "ref"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: ('auto',) + {IMPLS}")
    if impl == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got tensors on {device}")
    return impl


def assign(x, c: torch.Tensor, *, impl: str = "auto",
           precision: str = "auto", chunk: int = 65536
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid: x [m,n], c [k,n] -> (ids int32 [m], d f32 [m])."""
    impl = resolve_impl(impl, x.device)
    precision = resolve_precision(precision, x)
    if precision == "int8":
        x = px.as_quantized(x)          # one scale row for the whole chunk
    if impl == "cuda":
        kernel = _KERNELS[precision]["assign"]
        xs = px.cast_storage(x, precision)
        return _tuned("assign", partial(kernel, xs, c), xs, 1, c.shape[0],
                      precision)
    if impl == "ref":
        return ref.assign_ref(x, c, precision=precision)
    starts = range(0, x.shape[0], chunk)
    blocks = ([px.QuantizedChunk(x.q[i:i + chunk], x.scale) for i in starts]
              if precision == "int8" else [x[i:i + chunk] for i in starts])
    parts = [ref.assign_ref(b, c, precision=precision) for b in blocks]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def warm_assign(m: int, k: int, n: int, *, impl: str = "auto",
                precision: str = "auto", dtype=torch.float32,
                device=None) -> str:
    """Run :func:`assign` once, eagerly, at ``(m, k, n)``; return the impl
    that shape runs.

    The port of the reference's ``ops.warm_assign``
    (``repro/kernels/ops.py:212``).  Serving replays each bucket's assign
    launch from a CUDA graph (``serve/registry.py``), and nothing inside a
    capture may synchronise the card: this eager call on zeros of
    ``dtype`` (the serving buckets' f32; :func:`assign` casts to the
    policy's storage, as in the graph) builds the kernels and consults and
    fills the autotune cache first, so the capture finds its launch choice
    cached.  It runs on ``device`` (None: the card) and synchronises it, so
    a launch fault surfaces here.

    Departure, stated: a kernel that fails to build or launch here
    *raises*.  The reference demotes the shape to its oracle
    (``record_demotion``); the port keeps no demotion table (see the
    module docstring), in serving as in ``fit``.
    """
    dev = devices.resolve(device)
    impl = resolve_impl(impl, dev)
    x = torch.zeros((m, n), dtype=dtype, device=dev)
    c = torch.zeros((k, n), dtype=torch.float32, device=dev)
    assign(x, c, impl=impl, precision=px.resolve(precision, x.dtype))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return impl


def update(x, ids: torch.Tensor, k: int, *,
           weights: torch.Tensor | None = None, impl: str = "auto",
           precision: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster sums/counts: x [m,n], ids [m] -> (sums [k,n], counts [k]).

    Weighted (``weights`` [m]): the weighted contraction of
    :func:`.ref.update_ref` on every device, as in the reference, whose
    weighted update runs outside any Pallas kernel (``ops.py:260-261``).
    """
    impl = resolve_impl(impl, x.device)
    precision = resolve_precision(precision, x)
    if weights is not None:
        return ref.update_ref(x, ids, k, weights, precision=precision)
    if impl == "cuda":
        kernel = _KERNELS[precision]["update"]
        return kernel(px.cast_storage(x, precision), ids, k)
    return ref.update_ref(x, ids, k, precision=precision)


def fused_step(x, c: torch.Tensor, *,
               weights: torch.Tensor | None = None, impl: str = "auto",
               precision: str = "auto"
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration's (sums, counts, objective): kernel A at the
    policy (A8, A16, A3; or its dma twin, as the tuner says) inside the
    fused envelope, two passes (assign + update: kernels B and C at the
    policy) outside it.  A weighted step never enters a fused kernel: its
    ids and d come from :func:`assign` (kernel B at the policy on the
    card), its sums and counts from the weighted contraction of
    :func:`update`, and its objective is ``sum(d * w)``."""
    impl = resolve_impl(impl, x.device)
    precision = resolve_precision(precision, x)
    if precision == "int8":
        x = px.as_quantized(x)          # quantized once for both passes
    k = c.shape[0]
    if weights is None and impl == "cuda" and fused.fits(k, c.shape[1]):
        kernel = _KERNELS[precision]["fused"]
        xs = px.cast_storage(x, precision)
        return _tuned("fused", partial(kernel, xs, c), xs, 1, k, precision)
    ids, d = assign(x, c, impl=impl, precision=precision)
    sums, counts = update(x, ids, k, weights=weights, impl=impl,
                          precision=precision)
    obj = torch.sum(d) if weights is None else torch.sum(d * weights)
    return sums, counts, obj


def fused_step_batched(x, c: torch.Tensor, *,
                       impl: str = "auto", precision: str = "auto"
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B concurrent Lloyd iterations: x [B,m,n], c [B,k,n] -> (sums [B,k,n],
    counts [B,k], obj [B]).

    ``'cuda'``: kernel D at the policy (D8, D16, D3) inside the fused
    envelope (one launch for all streams), else the two-pass route through
    kernels B and C at the policy stream by stream.  ``'ref'`` /
    ``'ref_chunked'``: the reference's batched oracle
    (``ops._fused_step_batched_ref``), the oracles stream by stream on x as
    given.  Under int8 each stream has its own scale row.
    """
    impl = resolve_impl(impl, x.device)
    precision = resolve_precision(precision, x)
    int8 = precision == "int8"
    if int8:
        x = px.as_quantized(x)
    if impl != "cuda":
        if int8:
            return fused.fused_step_batched_int8_plain(x, c)
        sums, counts, obj = zip(*(fused_step(x[b], c[b], impl="ref",
                                             precision=precision)
                                  for b in range(x.shape[0])))
        return torch.stack(sums), torch.stack(counts), torch.stack(obj)
    if fused.fits_batched(c.shape[1], c.shape[2]):
        kernel = _KERNELS[precision]["batched"]
        xs = px.cast_storage(x, precision)
        return _tuned("fused_batched", partial(kernel, xs, c), xs,
                      x.shape[0], c.shape[1], precision)
    streams = ((px.QuantizedChunk(x.q[b], x.scale[b]) if int8 else x[b])
               for b in range(x.shape[0]))
    sums, counts, obj = zip(*(fused_step(xb, c[b], impl="cuda",
                                         precision=precision)
                              for b, xb in enumerate(streams)))
    return torch.stack(sums), torch.stack(counts), torch.stack(obj)
