"""One Lloyd iteration in one pass: CUDA kernel A (``csrc/fused_step.cu``).

Replaces ``repro/kernels/fused_step.py:fused_step_pallas`` with
``pipeline="blocks"`` (f32 body): assignment, sums, counts and objective in
one read of the chunk.  :func:`fits` is the reference's envelope; outside it
``ops.fused_step`` takes the two-pass route (kernels B and C).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

# The reference's envelope (repro/kernels/fused_step.py:MAX_K, MAX_N,
# _MAX_KN_ELEMS, _batched_tiles): the dispatch follows it so that both
# packages take the same route for a shape.
MAX_K = 1024
MAX_N = 4096
_MAX_KN_ELEMS = 1 << 20
_BLOCK_K = 128
_BLOCK_N = 512

launches = 0        # kernel launches by fused_step_f32 (ops.launch_counts)


def _padded(k: int, n: int) -> tuple[int, int]:
    k_pad = -(-k // _BLOCK_K) * _BLOCK_K
    n_pad = -(-n // 128) * 128
    block_n = n_pad if n_pad <= _BLOCK_N else _BLOCK_N
    return k_pad, -(-n_pad // block_n) * block_n


def fits(k: int, n: int) -> bool:
    k_pad, n_pad = _padded(k, n)
    return k <= MAX_K and n <= MAX_N and k_pad * n_pad <= _MAX_KN_ELEMS


def fused_step_plain(x: torch.Tensor, c: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: two passes through the oracles."""
    ids, d = ref.assign_ref(x, c, precision="f32")
    sums, counts = ref.update_ref(x, ids, c.shape[0], precision="f32")
    return sums, counts, torch.sum(d)


def fused_step_f32(x: torch.Tensor, c: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [m,n] f32, c [k,n] f32 -> (sums f32 [k,n], counts f32 [k], obj f32).

    Runs any (k, n); the dispatch in ``ops`` restricts it to :func:`fits`.
    """
    if x.device.type == "cpu":
        return fused_step_plain(x, c)
    build.require("x", x, torch.float32, 2)
    build.require("c", c, torch.float32, 2)
    m, n = x.shape
    k = c.shape[0]
    if c.shape[1] != n or c.device != x.device or k < 1 or n < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} / c {tuple(c.shape)}"
                         f" on {x.device} / {c.device}")
    stride = k * n + k + 1
    grid = build.grid(x.device, m, stride)
    part = torch.empty(grid * stride, dtype=torch.float32, device=x.device)
    out = torch.empty(stride, dtype=torch.float32, device=x.device)
    lib = build.load()
    global launches
    launches += 1
    err = lib.repro_fused_step_f32(
        x.data_ptr(), c.data_ptr(), part.data_ptr(), out.data_ptr(), m, k, n,
        grid, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_step_f32")
    return out[:k * n].view(k, n), out[k * n:k * n + k], out[k * n + k]
