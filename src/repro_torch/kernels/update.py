"""Centroid-update statistics: CUDA kernel C (``csrc/update.cu``).

Replaces ``repro/kernels/update.py:update_pallas`` (f32 body).  The wrapper
:func:`update_f32` launches the kernel on CUDA tensors and raises
``ValueError`` on any other; :func:`update_plain` is the plain version that
``ops`` runs for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0            # kernel launches by update_f32 (see ops.launch_counts)


def update_plain(x: torch.Tensor, ids: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (sums f32 [k,n], counts f32 [k])."""
    return ref.update_ref(x, ids, k, precision="f32")


def update_f32(x: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m,n] f32, ids [m] int32 -> (sums f32 [k,n], counts f32 [k]).

    An id outside [0, k) adds nothing.  The per-CTA partials are reduced in
    CTA order, so repeated calls are bitwise equal.
    """
    build.require("x", x, torch.float32, 2)
    build.require("ids", ids, torch.int32, 1)
    m, n = x.shape
    if ids.shape[0] != m or ids.device != x.device or k < 1 or n < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} / ids "
                         f"{tuple(ids.shape)} / k={k}")
    stride = k * n + k
    grid = build.grid(x.device, m, stride)
    part = torch.empty(grid * stride, dtype=torch.float32, device=x.device)
    out = torch.empty(stride, dtype=torch.float32, device=x.device)
    lib = build.load()
    global launches
    launches += 1
    err = lib.repro_update_f32(
        x.data_ptr(), ids.data_ptr(), part.data_ptr(), out.data_ptr(), m, k,
        n, grid, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "update_f32")
    return out[:k * n].view(k, n), out[k * n:]
