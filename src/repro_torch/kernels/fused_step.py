"""One Lloyd iteration in one pass: CUDA kernels A, D, A8, D8 and the bf16 /
bf16x3 bodies A16, A3, D16, D3.

Kernel A (``csrc/fused_step.cu``, :func:`fused_step_f32`) replaces
``repro/kernels/fused_step.py:fused_step_pallas`` with ``pipeline="blocks"``
(f32 body): assignment, sums, counts and objective in one read of the
chunk.  Kernel D (``csrc/fused_step_batched.cu``,
:func:`fused_step_batched_f32`) replaces ``fused_step_batched_pallas`` (f32
body): the same statistics for B streams in one launch, each stream bitwise
equal to kernel A on it.  Kernels A8 and D8 (``csrc/fused_step_int8.cu``,
``csrc/fused_step_batched_int8.cu``; :func:`fused_step_int8`,
:func:`fused_step_batched_int8`) are the int8 bodies of the same two Pallas
kernels, on a :class:`~.precision.QuantizedChunk`; D8's stream b is bitwise
A8 on it.  Kernels A16 / A3 (``csrc/fused_step_bf16.cu``,
:func:`fused_step_16`) and D16 / D3 (``csrc/fused_step_batched_bf16.cu``,
:func:`fused_step_batched_16`) are the bf16 and bf16x3 bodies; their
wrappers cast x to the policy's storage (bf16, or f32) before the kernel
takes both its norm and its dot, as the Pallas wrapper does
(``fused_step.py:330-332``), and the kernel takes ``||c||^2`` from the f32
centroids.  The wrappers launch their kernel on CUDA tensors and raise
``ValueError`` on any other; ``ops`` runs the plain versions
(``*_plain``) for tensors on the CPU.  :func:`fits` is the reference's
envelope (``fits_batched`` is the same); outside it ``ops`` takes the
two-pass route (kernels B and C, or their int8 / bf16 / bf16x3 bodies).

The single-chunk wrappers take the reference's ``pipeline`` knob
(``fused_step.py:297``, :data:`PIPELINES`): ``"blocks"`` launches kernel A
(A8, A16, A3), ``"dma"`` its twin A-dma (``csrc/fused_step_dma.cu``), the
same CTA body on the same grid with the point slabs copied ahead into two
staging slots (``cp.async``), bitwise the same results.  The plain versions
take the knob and ignore it: both pipelines compute one function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import precision as px

# The reference's envelope (repro/kernels/fused_step.py:MAX_K, MAX_N,
# _MAX_KN_ELEMS, _batched_tiles): the dispatch follows it so that both
# packages take the same route for a shape.
MAX_K = 1024
MAX_N = 4096
_MAX_KN_ELEMS = 1 << 20
_BLOCK_K = 128
_BLOCK_N = 512
PIPELINES = ("blocks", "dma")

launches = 0          # kernel launches by fused_step_f32 (ops.launch_counts)
batched_launches = 0  # kernel launches by fused_step_batched_f32
int8_launches = 0     # kernel launches by fused_step_int8
batched_int8_launches = 0  # kernel launches by fused_step_batched_int8
# kernel launches by fused_step_16 / fused_step_batched_16, per policy
launches16 = dict.fromkeys(("bf16", "bf16x3"), 0)
batched_launches16 = dict.fromkeys(("bf16", "bf16x3"), 0)
# kernel launches of the pipeline="dma" entry points, per policy
dma_launches = dict.fromkeys(("f32", "int8", "bf16", "bf16x3"), 0)


def check_pipeline(pipeline: str) -> str:
    """``pipeline`` if it is one of :data:`PIPELINES`, else ValueError (the
    reference's ``fused_step.py:314-315``)."""
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; known: {PIPELINES}")
    return pipeline


def _launch(precision: str, pipeline: str):
    """The C entry point of the single-chunk fused step at ``precision``
    under ``pipeline``, its launch counted."""
    global launches, int8_launches
    lib = build.load()
    entry = f"repro_fused_step_{precision}"
    if check_pipeline(pipeline) == "dma":
        dma_launches[precision] += 1
        build.count_launch("fused_step_dma"
                           + ("" if precision == "f32" else f"_{precision}"))
        return getattr(lib, f"{entry}_dma")
    if precision == "f32":
        launches += 1
    elif precision == "int8":
        int8_launches += 1
    else:
        launches16[precision] += 1
    build.count_launch(f"fused_step_{precision}" if precision != "f32"
                       else "fused_step")
    return getattr(lib, entry)


def _padded(k: int, n: int) -> tuple[int, int]:
    k_pad = -(-k // _BLOCK_K) * _BLOCK_K
    n_pad = -(-n // 128) * 128
    block_n = n_pad if n_pad <= _BLOCK_N else _BLOCK_N
    return k_pad, -(-n_pad // block_n) * block_n


def fits(k: int, n: int) -> bool:
    k_pad, n_pad = _padded(k, n)
    return k <= MAX_K and n <= MAX_N and k_pad * n_pad <= _MAX_KN_ELEMS


# The single and batched kernels share one envelope, as in the reference.
fits_batched = fits


def fused_step_plain(x: torch.Tensor, c: torch.Tensor, precision: str = "f32",
                     pipeline: str = "blocks"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel A (A16, A3 under ``'bf16'``,
    ``'bf16x3'``; either pipeline): x cast to the policy's storage, as the
    kernel's wrapper casts it, then two passes through the oracles."""
    check_pipeline(pipeline)
    x = px.cast_storage(x, precision)
    ids, d = ref.assign_ref(x, c, precision=precision)
    sums, counts = ref.update_ref(x, ids, c.shape[0], precision=precision)
    return sums, counts, torch.sum(d)


def fused_step_f32(x: torch.Tensor, c: torch.Tensor, pipeline: str = "blocks"
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [m,n] f32, c [k,n] f32 -> (sums f32 [k,n], counts f32 [k], obj f32):
    kernel A, or A-dma under ``pipeline="dma"``.

    Runs any (k, n); the dispatch in ``ops`` restricts it to :func:`fits`.
    Raises ``ValueError`` unless x and c are CUDA tensors, or for an unknown
    pipeline.
    """
    check_pipeline(pipeline)
    build.require("x", x, torch.float32, 2)
    build.require("c", c, torch.float32, 2)
    m, k, n = build.xc_shapes(x, c)
    stride = k * n + k + 1
    grid = build.grid(x.device, m, stride)
    part = torch.empty(grid * stride, dtype=torch.float32, device=x.device)
    out = torch.empty(stride, dtype=torch.float32, device=x.device)
    launch = _launch("f32", pipeline)
    err = launch(
        x.data_ptr(), c.data_ptr(), part.data_ptr(), out.data_ptr(), m, k, n,
        grid, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"fused_step_f32 ({pipeline})")
    return out[:k * n].view(k, n), out[k * n:k * n + k], out[k * n + k]


def fused_step_batched_plain(x: torch.Tensor, c: torch.Tensor,
                             precision: str = "f32"
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The plain PyTorch version of kernel D (D16, D3):
    :func:`fused_step_plain` stream by stream."""
    sums, counts, obj = zip(*(fused_step_plain(x[b], c[b], precision)
                              for b in range(x.shape[0])))
    return torch.stack(sums), torch.stack(counts), torch.stack(obj)


def fused_step_batched_f32(x: torch.Tensor, c: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x [B,m,n] f32, c [B,k,n] f32 -> (sums f32 [B,k,n], counts f32 [B,k],
    obj f32 [B]).

    Stream b is bitwise equal to :func:`fused_step_f32` on (x[b], c[b]):
    every stream gets kernel A's grid for (m, k, n).  The per-CTA partials
    of a launch are capped at ``build.SCRATCH_BYTES``, so the streams go in
    groups of :func:`build.stream_group` (one launch each; one launch for
    all B at the main path's shapes).  Runs any (k, n); the dispatch in
    ``ops`` restricts it to :func:`fits_batched`.  Raises ``ValueError``
    unless x and c are CUDA tensors.
    """
    build.require("x", x, torch.float32, 3)
    build.require("c", c, torch.float32, 3)
    batch, m, k, n = build.xc_shapes(x, c)
    stride = k * n + k + 1
    grid = build.grid(x.device, m, stride)
    group = min(batch, build.stream_group(grid, stride))
    part = torch.empty(group * grid * stride, dtype=torch.float32,
                       device=x.device)
    out = torch.empty((batch, stride), dtype=torch.float32, device=x.device)
    lib = build.load()
    st = torch.cuda.current_stream(x.device).cuda_stream
    global batched_launches
    for b0 in range(0, batch, group):
        nb = min(group, batch - b0)
        batched_launches += 1
        build.count_launch("fused_step_batched")
        err = lib.repro_fused_step_batched_f32(
            x[b0].data_ptr(), c[b0].data_ptr(), part.data_ptr(),
            out[b0].data_ptr(), nb, m, k, n, grid, st)
        build.check(err, "fused_step_batched_f32")
    kn = k * n
    return out[:, :kn].view(batch, k, n), out[:, kn:kn + k], out[:, kn + k]


# --------------------------------------------------------------------------
# bf16 and bf16x3 bodies (kernels A16, A3, D16, D3)
# --------------------------------------------------------------------------


def fused_step_16(x: torch.Tensor, c: torch.Tensor, precision: str,
                  pipeline: str = "blocks"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A16 (``precision="bf16"``) or A3 (``"bf16x3"``), or its dma
    twin under ``pipeline="dma"``.

    x is cast to the policy's storage first, so ``||x||^2`` comes from the
    stored values; the kernel's first launch takes ``||c||^2`` from the f32
    centroids.  Runs any (k, n); the dispatch in ``ops`` restricts it to
    :func:`fits`.  Raises ``ValueError`` unless x and c are CUDA tensors.
    """
    if precision not in launches16:
        raise ValueError(f"not a bf16 / bf16x3 body: {precision!r}")
    check_pipeline(pipeline)
    x = px.cast_storage(x, precision)
    build.require("x", x, px.storage_dtype(precision), 2)
    build.require("c", c, torch.float32, 2)
    m, k, n = build.xc_shapes(x, c)
    stride = k * n + k + 1
    grid = build.grid(x.device, m, stride)
    csq = torch.empty(k, dtype=torch.float32, device=x.device)
    part = torch.empty(grid * stride, dtype=torch.float32, device=x.device)
    out = torch.empty(stride, dtype=torch.float32, device=x.device)
    launch = _launch(precision, pipeline)
    err = launch(x.data_ptr(), c.data_ptr(), csq.data_ptr(), part.data_ptr(),
                 out.data_ptr(), m, k, n, grid,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"fused_step_{precision} ({pipeline})")
    return out[:k * n].view(k, n), out[k * n:k * n + k], out[k * n + k]


def fused_step_batched_16(x: torch.Tensor, c: torch.Tensor, precision: str
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Kernel D16 (``precision="bf16"``) or D3 (``"bf16x3"``): (sums f32
    [B,k,n], counts f32 [B,k], obj f32 [B]).

    Stream b is bitwise equal to :func:`fused_step_16` on (x[b], c[b]):
    every stream gets that kernel's grid, and the streams go in groups of
    :func:`build.stream_group` as in :func:`fused_step_batched_f32`.
    Raises ``ValueError`` unless x and c are CUDA tensors.
    """
    if precision not in launches16:
        raise ValueError(f"not a bf16 / bf16x3 body: {precision!r}")
    x = px.cast_storage(x, precision)
    build.require("x", x, px.storage_dtype(precision), 3)
    build.require("c", c, torch.float32, 3)
    batch, m, k, n = build.xc_shapes(x, c)
    stride = k * n + k + 1
    grid = build.grid(x.device, m, stride)
    group = min(batch, build.stream_group(grid, stride))
    csq = torch.empty((batch, k), dtype=torch.float32, device=x.device)
    part = torch.empty(group * grid * stride, dtype=torch.float32,
                       device=x.device)
    out = torch.empty((batch, stride), dtype=torch.float32, device=x.device)
    launch = getattr(build.load(), f"repro_fused_step_batched_{precision}")
    st = torch.cuda.current_stream(x.device).cuda_stream
    for b0 in range(0, batch, group):
        nb = min(group, batch - b0)
        batched_launches16[precision] += 1
        build.count_launch(f"fused_step_batched_{precision}")
        err = launch(x[b0].data_ptr(), c[b0].data_ptr(), csq[b0].data_ptr(),
                     part.data_ptr(), out[b0].data_ptr(), nb, m, k, n, grid,
                     st)
        build.check(err, f"fused_step_batched_{precision}")
    kn = k * n
    return out[:, :kn].view(batch, k, n), out[:, kn:kn + k], out[:, kn + k]


# --------------------------------------------------------------------------
# int8 bodies (kernels A8 and D8)
# --------------------------------------------------------------------------


def fused_step_int8_plain(x, c: torch.Tensor, pipeline: str = "blocks"
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The plain PyTorch version of :func:`fused_step_int8` (either
    pipeline): two passes through the int8 oracles on one quantized chunk
    (the reference's ``ops.fused_step(..., impl="ref",
    precision="int8")``)."""
    check_pipeline(pipeline)
    qx = px.as_quantized(x)
    ids, d = ref.assign_ref(qx, c, precision="int8")
    sums, counts = ref.update_ref(qx, ids, c.shape[0], precision="int8")
    return sums, counts, torch.sum(d)


def fused_step_batched_int8_plain(x, c: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The plain PyTorch version of :func:`fused_step_batched_int8`:
    :func:`fused_step_int8_plain` stream by stream, each stream with its
    own scale row."""
    qx = px.as_quantized(x)
    sums, counts, obj = zip(*(
        fused_step_int8_plain(px.QuantizedChunk(qx.q[b], qx.scale[b]), c[b])
        for b in range(qx.q.shape[0])))
    return torch.stack(sums), torch.stack(counts), torch.stack(obj)


def fused_step_int8(x, c: torch.Tensor, pipeline: str = "blocks"
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: a :class:`~.precision.QuantizedChunk` (codes int8 [m,n], scales
    f32 [n]; a plain tensor is quantized first), c [k,n] f32 -> (sums f32
    [k,n], counts f32 [k], obj f32).

    Quantizes the centroids into the chunk's scaled space, launches kernel
    A8 (A8-dma under ``pipeline="dma"``; :func:`launch_fused_step_int8`)
    and turns its exact int32 sums into f32 data space (``isums.float() *
    scale``) after the full reduce, as the reference's wrapper does
    (``fused_step.py:400-403``).  Runs any (k, n); the dispatch in ``ops``
    restricts it to :func:`fits`.  Raises ``ValueError`` unless the
    operands are CUDA tensors.
    """
    check_pipeline(pipeline)
    q, scale, c, cq, t = build.int8_operands(x, c, 2)
    isums, counts, obj = launch_fused_step_int8(q, scale, cq, t, c, pipeline)
    return isums.float() * scale[None, :], counts, obj


def launch_fused_step_int8(q: torch.Tensor, scale: torch.Tensor,
                           cq: torch.Tensor, t: torch.Tensor,
                           c: torch.Tensor, pipeline: str = "blocks"
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Kernel A8 (or A8-dma) on validated operands (see
    :func:`fused_step_int8`; ``c`` the full-width f32 centroids, whose
    norms it takes first): (isums int32 [k,n], counts f32 [k], obj f32)."""
    check_pipeline(pipeline)
    m, n = q.shape
    k = cq.shape[0]
    kn = k * n
    grid = build.grid(q.device, m, kn + k + 1)
    csq = torch.empty(k, dtype=torch.float32, device=q.device)
    psum = torch.empty(grid * kn, dtype=torch.int32, device=q.device)
    pf = torch.empty(grid * (k + 1), dtype=torch.float32, device=q.device)
    isums = torch.empty((k, n), dtype=torch.int32, device=q.device)
    out = torch.empty(k + 1, dtype=torch.float32, device=q.device)
    launch = _launch("int8", pipeline)
    err = launch(
        q.data_ptr(), cq.data_ptr(), c.data_ptr(), csq.data_ptr(),
        t.data_ptr(), scale.data_ptr(), psum.data_ptr(), pf.data_ptr(),
        isums.data_ptr(), out.data_ptr(), m, k, n, grid,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"fused_step_int8 ({pipeline})")
    return isums, out[:k], out[k]


def fused_step_batched_int8(x, c: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """x: a batched :class:`~.precision.QuantizedChunk` (codes int8
    [B,m,n], one scale row per stream [B,n]), c [B,k,n] f32 -> (sums f32
    [B,k,n], counts f32 [B,k], obj f32 [B]).

    Stream b is bitwise equal to :func:`fused_step_int8` on stream b: the
    centroids are quantized per stream, every stream gets kernel A8's grid,
    and the streams go in groups of :func:`build.stream_group` as in
    :func:`fused_step_batched_f32`.  Raises ``ValueError`` unless the
    operands are CUDA tensors.
    """
    q, scale, c, cq, t = build.int8_operands(x, c, 3)
    isums, counts, obj = launch_fused_step_batched_int8(q, scale, cq, t, c)
    return isums.float() * scale[:, None, :], counts, obj


def launch_fused_step_batched_int8(q: torch.Tensor, scale: torch.Tensor,
                                   cq: torch.Tensor, t: torch.Tensor,
                                   c: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Kernel D8 on validated operands (see :func:`fused_step_batched_int8`;
    ``c`` the full-width f32 centroids [B,k,n]): (isums int32 [B,k,n],
    counts f32 [B,k], obj f32 [B])."""
    batch, m, n = q.shape
    k = cq.shape[1]
    kn = k * n
    grid = build.grid(q.device, m, kn + k + 1)
    group = min(batch, build.stream_group(grid, kn + k + 1))
    psum = torch.empty(group * grid * kn, dtype=torch.int32, device=q.device)
    pf = torch.empty(group * grid * (k + 1), dtype=torch.float32,
                     device=q.device)
    isums = torch.empty((batch, k, n), dtype=torch.int32, device=q.device)
    out = torch.empty((batch, k + 1), dtype=torch.float32, device=q.device)
    csq = torch.empty((batch, k), dtype=torch.float32, device=q.device)
    lib = build.load()
    st = torch.cuda.current_stream(q.device).cuda_stream
    global batched_int8_launches
    for b0 in range(0, batch, group):
        nb = min(group, batch - b0)
        batched_int8_launches += 1
        build.count_launch("fused_step_batched_int8")
        err = lib.repro_fused_step_batched_int8(
            q[b0].data_ptr(), cq[b0].data_ptr(), c[b0].data_ptr(),
            csq[b0].data_ptr(), t[b0].data_ptr(), scale[b0].data_ptr(),
            psum.data_ptr(),
            pf.data_ptr(), isums[b0].data_ptr(), out[b0].data_ptr(), nb, m,
            k, n, grid, st)
        build.check(err, "fused_step_batched_int8")
    return isums, out[:, :k], out[:, k]
