"""Nearest-centroid assignment: CUDA kernel B (``csrc/assign.cu``).

Replaces ``repro/kernels/distance.py:assign_pallas`` (f32 body).  The
wrapper :func:`assign_f32` launches the kernel on CUDA tensors and raises
``ValueError`` on any other; :func:`assign_plain` is the plain version that
``ops`` runs for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0            # kernel launches by assign_f32 (see ops.launch_counts)


def assign_plain(x: torch.Tensor, c: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (ids int32 [m], d f32 [m])."""
    return ref.assign_ref(x, c, precision="f32")


def assign_f32(x: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m,n] f32, c [k,n] f32 -> (ids int32 [m], d f32 [m]).

    ``ids`` minimises ``||c||^2 - 2 x.c`` (ties: lowest index) and
    ``d = max(best + ||x||^2, 0)``.
    """
    build.require("x", x, torch.float32, 2)
    build.require("c", c, torch.float32, 2)
    m, n = x.shape
    k = c.shape[0]
    if c.shape[1] != n or c.device != x.device or k < 1 or n < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} / c {tuple(c.shape)}"
                         f" on {x.device} / {c.device}")
    ids = torch.empty(m, dtype=torch.int32, device=x.device)
    d = torch.empty(m, dtype=torch.float32, device=x.device)
    lib = build.load()
    global launches
    launches += 1
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_assign_f32(
        x.data_ptr(), c.data_ptr(), ids.data_ptr(), d.data_ptr(), m, k, n,
        build.grid(x.device, m), stream)
    build.check(err, "assign_f32")
    return ids, d
