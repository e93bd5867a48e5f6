"""The K-means++ candidate probe: CUDA kernel P.

Kernel P (``csrc/kpp_probe.cu``, :func:`kpp_probe_cuda`) replaces
``repro/kernels/kpp_probe.py:kpp_probe_pallas``: for points x [m,n],
L candidate seeds cands [L,n] and the current distances d [m] it returns
the relaxed distances ``newd [m,L] = min(d, max(||c||^2 - 2 x.c + ||x||^2,
0))`` and each candidate's potential ``pot [L]``, the sum of its column
over the rows, in one pass over the chunk and one launch (the last CTA
adds the per-CTA partials, found by an integer ticket that each launch
allocates with its partials, so a launch or a graph replay never shares
its ticket with another in flight).  Both operands are cast to f32 first, as the
reference's wrapper casts them (``kpp_probe.py:74-75``).
:func:`kpp_probe_plain` is its plain version, with the same association
``(csq - 2 dot) + xsq``; :func:`kpp_probe` takes the plain version for
tensors on the CPU and the kernel for tensors on the card.

``seed`` does not call it (in the reference neither: ``kmeanspp.seed``
runs its oracle, ``x2 - 2 dots + c2``, and the port's seed is held to it
decision by decision); it is its own entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# The reference's envelope (repro/kernels/kpp_probe.py:MAX_L, MAX_N).
MAX_L = 128
MAX_N = 1024

launches = 0    # kernel launches by kpp_probe_cuda (ops.launch_counts)
_PER_SM: dict = {}      # (device, L, n) -> CTAs an SM holds


def fits(l: int, n: int) -> bool:
    return l <= MAX_L and n <= MAX_N


def kpp_probe_plain(x: torch.Tensor, cands: torch.Tensor, d: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel P: (newd f32 [m,L], pot f32
    [L])."""
    x, cands = x.float(), cands.float()
    xsq = torch.sum(x * x, dim=1, keepdim=True)
    csq = torch.sum(cands * cands, dim=1)[None, :]
    dc = torch.clamp_min((csq - 2.0 * (x @ cands.T)) + xsq, 0.0)
    newd = torch.minimum(d.float()[:, None], dc)
    return newd, torch.sum(newd, dim=0)


def kpp_probe_cuda(x: torch.Tensor, cands: torch.Tensor, d: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel P: x [m,n], cands [L,n] (cast to f32), d f32 [m] -> (newd f32
    [m,L], pot f32 [L]), in one launch.

    Raises ``ValueError`` unless the operands are CUDA tensors and (L, n)
    :func:`fits`.
    """
    L, n = cands.shape[0], cands.shape[-1]
    if not fits(L, n):
        raise ValueError(f"kpp_probe takes L <= {MAX_L} candidates of n <= "
                         f"{MAX_N} features, got L={L}, n={n}")
    x = x.float().contiguous()
    cands = cands.float().contiguous()
    build.require("x", x, torch.float32, 2)
    build.require("cands", cands, torch.float32, 2)
    build.require("d", d, torch.float32, 1)
    m, L, n = build.xc_shapes(x, cands)
    if d.shape != (m,) or d.device != x.device:
        raise ValueError(f"d must be [{m}] on {x.device}, got "
                         f"{tuple(d.shape)} on {d.device}")
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    grid = build.grid(x.device, m, L,
                      per_sm=_ctas_per_sm(lib, x.device, L, n))
    newd = torch.empty((m, L), dtype=torch.float32, device=x.device)
    # the per-CTA partials and, after them, the launch's own ticket (the
    # entry point zeroes it on the stream): a graph captured with this
    # launch owns both
    scratch = torch.empty(grid * L + 1, dtype=torch.float32, device=x.device)
    ticket = scratch[grid * L:].view(torch.int32)
    pot = torch.empty(L, dtype=torch.float32, device=x.device)
    global launches
    launches += 1
    err = lib.repro_kpp_probe(
        x.data_ptr(), cands.data_ptr(), d.data_ptr(), newd.data_ptr(),
        scratch.data_ptr(), pot.data_ptr(), ticket.data_ptr(), m, L, n,
        grid, stream)
    build.check(err, "kpp_probe")
    return newd, pot


def _ctas_per_sm(lib, device: torch.device, L: int, n: int) -> int:
    """CTAs of kernel P an SM holds at (L, n) (its shared memory)."""
    key = (device.index, L, n)
    per_sm = _PER_SM.get(key)
    if per_sm is None:
        per_sm = lib.repro_kpp_probe_ctas_per_sm(L, n)
        if per_sm < 0:
            build.check(-per_sm, "kpp_probe occupancy")
        if per_sm == 0:
            raise RuntimeError(f"kpp_probe: no CTA fits an SM at L={L}, "
                               f"n={n}")
        _PER_SM[key] = per_sm
    return per_sm


def kpp_probe(x: torch.Tensor, cands: torch.Tensor, d: torch.Tensor, *,
              impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """The probe on the device of ``x``: kernel P for CUDA tensors
    (``impl`` ``'auto'`` or ``'cuda'``), the plain version for CPU tensors
    or under ``impl="ref"``."""
    from repro_torch.kernels import ops

    if ops.resolve_impl(impl, x.device) == "cuda":
        return kpp_probe_cuda(x, cands, d)
    return kpp_probe_plain(x, cands, d)
