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

:class:`SlotChain` runs a K-means++ seeding's slots on the card for
``core.kmeanspp.seed`` (a stated departure from the reference, whose
``seed`` runs its oracle, ``x2 - 2 dots + c2``): a slot is kernel G
(``csrc/kpp_draw.cu``: the D² draw and the gather of the candidates, and
the previous slot's pick) and kernel P, two launches in stream order with
no host read, so the host queues the slots ahead of the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# The reference's envelope (repro/kernels/kpp_probe.py:MAX_L, MAX_N).
MAX_L = 128
MAX_N = 1024

launches = 0    # launches of kernel P (ops.launch_counts)
draw_launches = 0   # launches of kernel G (ops.launch_counts)
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


def d2_logits(d: torch.Tensor) -> torch.Tensor:
    """log-weights for D² sampling; uniform when all distances are 0
    (reference ``kmeanspp.py:_safe_d2_logits``)."""
    total = torch.sum(d)
    logits = torch.log(torch.clamp_min(d, 1e-30))
    return torch.where(total > 0, logits, torch.zeros_like(d))


def kpp_draw_plain(x: torch.Tensor, noise: torch.Tensor, d: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel G's draw, and the oracle
    chain's (``core.kmeanspp``): the L candidates' rows ``argmax(noise +
    d2_logits(d))`` (int64 [L]) and the candidates x[idx] [L,n]."""
    idx = torch.argmax(noise + d2_logits(d)[None, :], dim=1)
    return idx, x[idx]


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
    # the per-CTA partials and, after them, the launch's own ticket, zeroed
    # on the stream: a graph captured with this launch owns both
    scratch = torch.empty(grid * L + 1, dtype=torch.float32, device=x.device)
    ticket = scratch[grid * L:].view(torch.int32).zero_()
    pot = torch.empty(L, dtype=torch.float32, device=x.device)
    global launches
    launches += 1
    build.count_launch("kpp_probe")
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


def draw_grid(device: torch.device, s: int) -> int:
    """CTAs of a kernel-G launch over ``s`` rows: 1,024 rows a CTA or
    more, four CTAs an SM at most (the result does not depend on it)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(4 * sms, -(-s // 1024)))


class SlotChain:
    """One K-means++ seeding's slots on the card, launched in order on the
    current stream; the host reads nothing.

    ``x`` f32 [s, n] and ``c`` f32 [k, n] contiguous CUDA tensors, ``d`` f32
    [s] the distances to the surviving centroids.  :meth:`slot` runs slot
    ``j``: kernel G (:meth:`draw`) draws its L candidates from ``d`` and its
    noise (the D² draw of ``kmeanspp._seed``) and gathers them, after
    writing the previous slot's pick (the candidate of least potential) to
    its row of ``c`` and its distances to ``d``; kernel P probes them.
    :meth:`finish` writes the last slot's pick to its row of ``c`` (``d``
    stays as it was before that pick: the seeding needs it no more).
    ``c`` and ``d`` are updated in place.
    """

    def __init__(self, x: torch.Tensor, d: torch.Tensor, c: torch.Tensor,
                 L: int):
        s, n = x.shape
        if not fits(L, n):
            raise ValueError(f"kpp_probe takes L <= {MAX_L} candidates of "
                             f"n <= {MAX_N} features, got L={L}, n={n}")
        build.require("x", x, torch.float32, 2)
        build.require("d", d, torch.float32, 1)
        build.require("c", c, torch.float32, 2)
        if d.shape != (s,) or c.shape[1] != n:
            raise ValueError(f"bad shapes x {tuple(x.shape)} / d "
                             f"{tuple(d.shape)} / c {tuple(c.shape)}")
        dev = x.device
        lib = self._lib = build.load()
        pgrid = build.grid(dev, s, L, per_sm=_ctas_per_sm(lib, dev, L, n))
        dgrid = draw_grid(dev, s)
        f32 = {"dtype": torch.float32, "device": dev}
        self.newd = torch.empty((s, L), **f32)
        self.pot = torch.empty(L, **f32)
        self.cands = torch.empty((L, n), **f32)
        self.idx = torch.empty(L, dtype=torch.int64, device=dev)
        # the CTAs' partials of P and G, and their tickets (zeroed once;
        # each launch leaves its ticket at zero)
        self._ppart = torch.empty(pgrid * L, **f32)
        self._dpart_v = torch.empty(dgrid * L * 2, **f32)
        self._dpart_i = torch.empty(dgrid * (L * 2 + 1), dtype=torch.int32,
                                    device=dev)
        self._tickets = torch.zeros(2, dtype=torch.int32, device=dev)
        self._x, self._d, self._c = x, d, c
        ticket = self._tickets.data_ptr()
        # the launches' operands, but for G the noise, the previous
        # slot's probe and its centroid row, and for both the stream
        self._draw = (x.data_ptr(), d.data_ptr(), self.newd.data_ptr(),
                      self.pot.data_ptr(), self.cands.data_ptr(),
                      self.idx.data_ptr(), self._dpart_v.data_ptr(),
                      self._dpart_i.data_ptr(), ticket, s, L, n, dgrid)
        self._probe = (x.data_ptr(), self.cands.data_ptr(), d.data_ptr(),
                       self.newd.data_ptr(), self._ppart.data_ptr(),
                       self.pot.data_ptr(), ticket + 4, s, L, n, pgrid)
        self._pending = None     # the slot whose pick is not written yet

    def _stream(self) -> int:
        return torch.cuda.current_stream(self._x.device).cuda_stream

    def draw(self, noise: torch.Tensor | None) -> None:
        """Kernel G alone: the pending slot's pick (if any), then the draw
        of L candidates from ``d`` and ``noise`` [L, s] into :attr:`idx`
        and :attr:`cands`; ``noise`` None: the pending pick alone (one
        CTA)."""
        global draw_launches
        x, d, newd, pot, cands, idx, pv, pi, ticket, s, L, n, grid = \
            self._draw
        if noise is not None:
            if noise.shape != (L, s):
                raise ValueError(f"noise must be [{L}, {s}], got "
                                 f"{tuple(noise.shape)}")
            noise = noise.to(device=self._x.device,
                             dtype=torch.float32).contiguous()
        j = self._pending
        prev = j is not None
        row = self._c.data_ptr() + 4 * n * j if prev else None
        draw_launches += 1
        build.count_launch("kpp_draw")
        err = self._lib.repro_kpp_draw(
            x, None if noise is None else noise.data_ptr(), d,
            newd if prev else None, pot if prev else None, row, cands, idx,
            pv, pi, ticket, s, L, n, 1 if noise is None else grid,
            self._stream())
        build.check(err, "kpp_draw")

    def slot(self, noise: torch.Tensor, j: int) -> None:
        """Slot ``j`` (a row of ``c``) with its Gumbel noise [L, s]."""
        global launches
        if not 0 <= j < self._c.shape[0]:
            raise IndexError(f"slot {j} of {self._c.shape[0]}")
        self.draw(noise)
        launches += 1
        build.count_launch("kpp_probe")
        build.check(self._lib.repro_kpp_probe(*self._probe, self._stream()),
                    "kpp_probe")
        self._pending = j

    def finish(self) -> None:
        """Write the last slot's pick to its row of ``c``."""
        if self._pending is not None:
            self.draw(None)
            self._pending = None
