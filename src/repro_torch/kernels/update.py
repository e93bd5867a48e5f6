"""Centroid-update statistics: CUDA kernels C, C8, C16 and C3.

Kernel C (``csrc/update.cu``, :func:`update_f32`) replaces
``repro/kernels/update.py:update_pallas`` (f32 body); kernel C8
(``csrc/update_int8.cu``, :func:`update_int8`) replaces its int8 variant
``_update_pallas_q``; kernels C16 and C3 (``csrc/update_bf16.cu``,
:func:`update_16`) its bf16 and bf16x3 bodies,
whose wrapper casts x to the policy's storage first.  The wrappers launch
their kernel on CUDA tensors and raise ``ValueError`` on any other;
:func:`update_plain` and :func:`update_int8_plain` are the plain versions
that ``ops`` runs for tensors on the CPU.

All four are a sorted scatter (``csrc/update.cuh``): a tile pass sums each
cluster's rows of each 256-row tile into a compact record, and a reduce
folds each cluster's records in the association of the one-hot kernels
they replaced, whose grid :func:`order` still gives.  The outputs are
bitwise those kernels'.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import precision as px

launches = 0            # kernel launches by update_f32 (see ops.launch_counts)
int8_launches = 0       # kernel launches by update_int8
# kernel launches by update_16, per policy
launches16 = dict.fromkeys(("bf16", "bf16x3"), 0)


def update_plain(x: torch.Tensor, ids: torch.Tensor, k: int,
                 precision: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel C (C16, C3 under ``'bf16'``,
    ``'bf16x3'``), x cast to the policy's storage as the kernel's wrapper
    casts it: (sums f32 [k,n], counts f32 [k])."""
    return ref.update_ref(px.cast_storage(x, precision), ids, k,
                          precision=precision)


def order(device: torch.device, m: int, k: int, n: int) -> int:
    """G, the association of the reduce: the grid of the one-hot update
    kernels the sorted scatter replaced (per-CTA partials of k n + k
    floats), whose sums it reproduces bitwise (``csrc/update.cuh``)."""
    return build.grid(device, m, k * n + k)


def scratch(device: torch.device, m: int, k: int, n: int, dtype
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tile pass's records: (sums [tiles * slots, n rounded up to 4]
    of ``dtype``, counts f32 [tiles * slots], index int32 [k, tiles]),
    slots = min(256, k) per tile."""
    tiles = -(-m // build.TILE_ROWS)
    slots = tiles * min(build.TILE_ROWS, k)
    if slots >= 2 ** 31:
        raise ValueError(f"m={m}, k={k}: {slots} record slots exceed int32")
    return (torch.empty(slots * -(-n // 4) * 4, dtype=dtype, device=device),
            torch.empty(slots, dtype=torch.float32, device=device),
            torch.empty(tiles * k, dtype=torch.int32, device=device))


def update_f32(x: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m,n] f32, ids [m] int32 -> (sums f32 [k,n], counts f32 [k]).

    An id outside [0, k) adds nothing.  Every sum is taken in a fixed
    order, so repeated calls are bitwise equal.
    """
    build.require("x", x, torch.float32, 2)
    build.require("ids", ids, torch.int32, 1)
    m, n = x.shape
    if ids.shape[0] != m or ids.device != x.device or k < 1 or n < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} / ids "
                         f"{tuple(ids.shape)} / k={k}")
    rec, rcnt, idx = scratch(x.device, m, k, n, torch.float32)
    out = torch.empty(k * n + k, dtype=torch.float32, device=x.device)
    lib = build.load()
    global launches
    launches += 1
    build.count_launch("update")
    err = lib.repro_update_f32(
        x.data_ptr(), ids.data_ptr(), rec.data_ptr(), rcnt.data_ptr(),
        idx.data_ptr(), out.data_ptr(), m, k, n, order(x.device, m, k, n),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "update_f32")
    return out[:k * n].view(k, n), out[k * n:]


def update_16(x: torch.Tensor, ids: torch.Tensor, k: int, precision: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel C16 (``precision="bf16"``) or C3 (``"bf16x3"``).  An id
    outside [0, k) adds nothing; every sum is taken in a fixed order, so
    repeated calls are bitwise equal."""
    if precision not in launches16:
        raise ValueError(f"not a bf16 / bf16x3 body: {precision!r}")
    x = px.cast_storage(x, precision)
    build.require("x", x, px.storage_dtype(precision), 2)
    build.require("ids", ids, torch.int32, 1)
    m, n = x.shape
    if ids.shape[0] != m or ids.device != x.device or k < 1 or n < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} / ids "
                         f"{tuple(ids.shape)} / k={k}")
    rec, rcnt, idx = scratch(x.device, m, k, n, torch.float32)
    out = torch.empty(k * n + k, dtype=torch.float32, device=x.device)
    launch = getattr(build.load(), f"repro_update_{precision}")
    launches16[precision] += 1
    build.count_launch(f"update_{precision}")
    err = launch(x.data_ptr(), ids.data_ptr(), rec.data_ptr(),
                 rcnt.data_ptr(), idx.data_ptr(), out.data_ptr(), m, k, n,
                 order(x.device, m, k, n),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"update_{precision}")
    return out[:k * n].view(k, n), out[k * n:]


def update_int8_plain(x, ids: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`update_int8`."""
    return ref.update_ref(px.as_quantized(x), ids, k, precision="int8")


def update_int8(x, ids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: a :class:`~.precision.QuantizedChunk` (codes int8 [m,n], scales
    f32 [n]; a plain tensor is quantized first), ids [m] int32 -> (sums f32
    [k,n], counts f32 [k]).

    The kernel sums the codes in exact int32; the sums become f32 data
    space (``isums.float() * scale``) after the full reduce, as the
    reference's wrapper does.  An id outside [0, k) adds nothing.
    """
    q, scale = px.as_quantized(x)
    build.require("x.q", q, torch.int8, 2)
    build.require("x.scale", scale, torch.float32, 1)
    build.require("ids", ids, torch.int32, 1)
    m, n = q.shape
    if (ids.shape[0] != m or scale.shape[0] != n or ids.device != q.device
            or scale.device != q.device or k < 1 or n < 1):
        raise ValueError(f"bad shapes x {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} / ids {tuple(ids.shape)} / "
                         f"k={k}")
    isums, counts = launch_update_int8(q, ids, k)
    return isums.float() * scale[None, :], counts


def launch_update_int8(q: torch.Tensor, ids: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel C8 on validated operands (see :func:`update_int8`):
    (isums int32 [k,n], counts f32 [k])."""
    m, n = q.shape
    rec, rcnt, idx = scratch(q.device, m, k, n, torch.int32)
    isums = torch.empty((k, n), dtype=torch.int32, device=q.device)
    counts = torch.empty(k, dtype=torch.float32, device=q.device)
    lib = build.load()
    global int8_launches
    int8_launches += 1
    build.count_launch("update_int8")
    err = lib.repro_update_int8(
        q.data_ptr(), ids.data_ptr(), rec.data_ptr(), rcnt.data_ptr(),
        idx.data_ptr(), isums.data_ptr(), counts.data_ptr(), m, k, n,
        order(q.device, m, k, n),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "update_int8")
    return isums, counts
