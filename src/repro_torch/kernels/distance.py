"""Nearest-centroid assignment: CUDA kernels B, B8, B16 and B3.

Kernel B (``csrc/assign.cu``, :func:`assign_f32`) replaces
``repro/kernels/distance.py:assign_pallas`` (f32 body); kernel B8
(``csrc/assign_int8.cu``, :func:`assign_int8`) replaces its int8 variant
``_assign_pallas_q``; kernels B16 and B3 (``csrc/assign_bf16.cu``,
:func:`assign_16`) its bf16 and bf16x3 bodies,
whose wrapper casts x to the policy's storage before the kernel takes its
norm and its dot.  B8, B16 and B3 run on the tensor cores, a wgmma product
with a fused argmin (``csrc/assign_mma.cuh``; B3 on the bf16 hi and lo
parts of both operands); B, true fp32, is a register-tiled product with a
fused argmin on the CUDA cores (``csrc/assign.cu``), bitwise the CUDA-core
body it replaced.
The wrappers launch their kernel on CUDA tensors and raise ``ValueError``
on any other; :func:`assign_plain` and :func:`assign_int8_plain` are the
plain versions that ``ops`` runs for tensors on the CPU.

Each wrapper takes ``ctas_per_sm`` (default 2), the launch's persistent
CTAs per SM over the output tiles: each output tile is one CTA's, so ids
and d do not depend on it, and the autotuner (``kernels/autotune.py``,
kind ``"assign"``) times it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import precision as px

TILE_ROWS = 128         # rows per output tile (MMA_BM, assign.cu:F32_BM)

launches = 0            # kernel launches by assign_f32 (see ops.launch_counts)
int8_launches = 0       # kernel launches by assign_int8
# kernel launches by assign_16, per policy
launches16 = dict.fromkeys(("bf16", "bf16x3"), 0)


def mma_n_tile(k: int) -> int:
    """Centroids per output tile of kernels B8, B16 and B3 (the wgmma's N)."""
    return 64 if k <= 64 else 128


def f32_n_tile(k: int) -> int:
    """Centroids per output tile of kernel B."""
    return 32 if k <= 32 else 128


def _tile_launch(x: torch.Tensor, m: int, k: int, bn: int,
                 ctas_per_sm: int):
    """(ids, d, sbest, sidx, grid) of a launch over output tiles of
    ``bn`` centroids: outputs, the per-tile scratch [ceil(k / bn), m] and
    the persistent grid."""
    tiles = -(-k // bn)
    ids = torch.empty(m, dtype=torch.int32, device=x.device)
    d = torch.empty(m, dtype=torch.float32, device=x.device)
    sbest = torch.empty((tiles, m), dtype=torch.float32, device=x.device)
    sidx = torch.empty((tiles, m), dtype=torch.int32, device=x.device)
    grid = build.persistent_grid(x.device, -(-m // TILE_ROWS) * tiles,
                                 per_sm=ctas_per_sm)
    return ids, d, sbest, sidx, grid


def assign_plain(x: torch.Tensor, c: torch.Tensor, precision: str = "f32"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel B (B16, B3 under ``'bf16'``,
    ``'bf16x3'``), x cast to the policy's storage as the kernel's wrapper
    casts it: (ids int32 [m], d f32 [m])."""
    return ref.assign_ref(px.cast_storage(x, precision), c,
                          precision=precision)


def assign_f32(x: torch.Tensor, c: torch.Tensor, ctas_per_sm: int = 2
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m,n] f32, c [k,n] f32 -> (ids int32 [m], d f32 [m]).

    ``ids`` minimises ``||c||^2 - 2 x.c`` (ties: lowest index) and
    ``d = max(best + ||x||^2, 0)``.
    """
    build.require("x", x, torch.float32, 2)
    build.require("c", c, torch.float32, 2)
    m, k, n = build.xc_shapes(x, c)
    bn = f32_n_tile(k)
    ids, d, sbest, sidx, grid = _tile_launch(x, m, k, bn, ctas_per_sm)
    csq = torch.empty(k, dtype=torch.float32, device=x.device)
    xsq = torch.empty(m if k > bn else 0, dtype=torch.float32,
                      device=x.device)
    lib = build.load()
    global launches
    launches += 1
    build.count_launch("assign")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_assign_f32(
        x.data_ptr(), c.data_ptr(), csq.data_ptr(), sbest.data_ptr(),
        sidx.data_ptr(), xsq.data_ptr(), ids.data_ptr(), d.data_ptr(), m, k,
        n, bn, grid, stream)
    build.check(err, "assign_f32")
    return ids, d


def assign_16(x: torch.Tensor, c: torch.Tensor, precision: str,
              ctas_per_sm: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B16 (``precision="bf16"``) or B3 (``"bf16x3"``).

    ``ids`` minimises ``||c||^2 - 2 x.c`` with the policy's dot (ties:
    lowest index) and ``d = max(best + ||x||^2, 0)``; ``||x||^2`` from x
    cast to the policy's storage, ``||c||^2`` from the f32 centroids (the
    kernel's first launch).
    """
    if precision not in launches16:
        raise ValueError(f"not a bf16 / bf16x3 body: {precision!r}")
    x = px.cast_storage(x, precision)
    build.require("x", x, px.storage_dtype(precision), 2)
    build.require("c", c, torch.float32, 2)
    m, k, n = build.xc_shapes(x, c)
    csq = torch.empty(k, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.load()
    launches16[precision] += 1
    build.count_launch(f"assign_{precision}")
    bn = mma_n_tile(k)
    ids, d, sbest, sidx, grid = _tile_launch(x, m, k, bn, ctas_per_sm)
    if precision == "bf16":
        cb = torch.empty((k, n), dtype=torch.bfloat16, device=x.device)
        err = lib.repro_assign_bf16(
            x.data_ptr(), c.data_ptr(), csq.data_ptr(), cb.data_ptr(),
            sbest.data_ptr(), sidx.data_ptr(), ids.data_ptr(), d.data_ptr(),
            m, k, n, bn, grid, stream)
    else:       # ||x||^2; the bf16 hi and lo parts of x and c, rows
        ld = -(-n // 8) * 8                       # padded to 16 bytes
        xsq = torch.empty(m, dtype=torch.float32, device=x.device)
        xh, xl, ch, cl = (torch.empty(shape, dtype=torch.bfloat16,
                                      device=x.device)
                          for shape in ((m, ld), (m, ld), (k, ld), (k, ld)))
        err = lib.repro_assign_bf16x3(
            x.data_ptr(), c.data_ptr(), csq.data_ptr(), xsq.data_ptr(),
            xh.data_ptr(), xl.data_ptr(), ch.data_ptr(), cl.data_ptr(),
            sbest.data_ptr(), sidx.data_ptr(), ids.data_ptr(), d.data_ptr(),
            m, k, n, bn, grid, stream)
    build.check(err, f"assign_{precision}")
    return ids, d


def assign_int8_plain(x, c: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`assign_int8`."""
    return ref.assign_ref(px.as_quantized(x), c, precision="int8")


def assign_int8(x, c: torch.Tensor, ctas_per_sm: int = 2
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: a :class:`~.precision.QuantizedChunk` (codes int8 [m,n], scales
    f32 [n]; a plain tensor is quantized first), c [k,n] f32 -> (ids int32
    [m], d f32 [m]).

    ``ids`` minimises ``csq - 2 * float(xq.cq) * t`` (ties: lowest index)
    with ``csq = ||c||^2`` from the full-width centroids and ``(cq, t)`` the
    centroids quantized in the chunk's scaled space; ``d = max(best +
    ||dequantize(x)||^2, 0)``.
    """
    q, scale, c, cq, t = build.int8_operands(x, c, 2)
    return launch_assign_int8(q, scale, cq, t, c, ctas_per_sm)


def launch_assign_int8(q: torch.Tensor, scale: torch.Tensor,
                       cq: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                       ctas_per_sm: int = 2
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B8 on validated operands (see :func:`assign_int8`; ``c`` the
    full-width f32 centroids, whose norms it takes first)."""
    m, n = q.shape
    k = cq.shape[0]
    csq = torch.empty(k, dtype=torch.float32, device=q.device)
    bn = mma_n_tile(k)
    ids, d, sbest, sidx, grid = _tile_launch(q, m, k, bn, ctas_per_sm)
    lib = build.load()
    global int8_launches
    int8_launches += 1
    build.count_launch("assign_int8")
    err = lib.repro_assign_int8(
        q.data_ptr(), cq.data_ptr(), c.data_ptr(), csq.data_ptr(),
        t.data_ptr(), scale.data_ptr(), sbest.data_ptr(), sidx.data_ptr(),
        ids.data_ptr(), d.data_ptr(), m, k, n, bn, grid,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "assign_int8")
    return ids, d
