"""What one rank dispatches: FLOPs, bytes, collectives and live memory, the
counterpart of the reference's ``repro.launch.hlo_analysis``.

The reference parses the optimized per-device HLO text.  The port has no
such module: it counts the aten ops that rank 0 dispatches while a step
runs on DTensors (:class:`Recorder`, a ``TorchDispatchMode``).  A DTensor
op is not counted itself: DTensor turns it into the collectives its
placements need and into local ops on this rank's shards, and those are
what the recorder sees.  The global-shape ops that DTensor's sharding
propagation runs on fake tensors to learn an output's shape are not this
rank's work: the recorder marks that propagation
(``ShardingPropagator._propagate_tensor_meta_non_cached``, wrapped while
it is active; a torch without it makes the recorder raise rather than
miscount) and skips what runs inside it.

A recorded op's row holds its name, the bytes of its tensor operands and
of its results, and its FLOPs by ``torch.utils.flop_counter``'s registry
(the products: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
attention kernels; an op outside the registry is decomposed first where it
can be, as ``FlopCounterMode`` does, so both count alike).  Views move no
bytes and make no row.  :func:`collective_bytes` reads the rows of the
``_c10d_functional`` collectives in the reference's vocabulary
(``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-broadcast``), operand bytes once a collective; a
``wait_tensor`` counts nothing, as an async pair's ``-done`` does there.

Memory: the recorder holds each storage its ops create while a tensor
uses it, so ``peak_bytes`` is the most this rank held at once beyond the
storages marked as the step's arguments (:meth:`Recorder.mark_arguments`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional")


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Row:
    op: str                 # aten op, or the collective's name
    in_bytes: int
    out_bytes: int
    flops: int
    collective: str | None = None


_tls = threading.local()


def _propagating() -> bool:
    return getattr(_tls, "propagating", 0) > 0


@contextlib.contextmanager
def _marked_propagation():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        _tls.propagating = getattr(_tls, "propagating", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _tls.propagating -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def storage_key(t: torch.Tensor) -> int:
    """An id of the storage ``t`` views (shared by its views)."""
    return t.untyped_storage()._cdata


class Recorder(TorchDispatchMode):
    """Records every op this rank dispatches (see the module docstring).

    ``fake_mode``: the ``FakeTensorMode`` of the step's tensors; ops on
    fake tensors of any other mode are not this rank's and are not
    recorded.  None: record every op on plain tensors (a real run)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self.fake_mode = fake_mode
        self.rows: list[Row] = []
        self._registry = flop_registry
        self._held = WeakIdKeyDictionary()    # tensor -> its storage key
        self._storages: dict[int, list] = {}  # key -> [bytes, tensors]
        self._arguments: set[int] = set()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._depth = 0
        self._marking = None

    def __enter__(self):
        if self._depth == 0:
            self._marking = _marked_propagation()
            self._marking.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._marking.__exit__(None, None, None)

    # ------------------------------------------------------------ counts
    @property
    def flops(self) -> int:
        return sum(r.flops for r in self.rows)

    @property
    def bytes(self) -> int:
        return sum(r.in_bytes + r.out_bytes for r in self.rows
                   if r.collective is None)

    # ------------------------------------------------------------ memory
    def mark_arguments(self, tensors) -> None:
        """Storages the step takes as arguments: not counted as live."""
        for t in tensors:
            self._arguments.add(storage_key(t))

    def _hold(self, t: torch.Tensor) -> None:
        if t in self._held or t.device.type == "meta":
            return
        key = storage_key(t)
        if key in self._arguments:
            return
        entry = self._storages.get(key)
        if entry is None:
            size = t.untyped_storage().nbytes()
            entry = self._storages[key] = [size, 0]
            self.live_bytes += size
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        self._held[t] = key
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    # ---------------------------------------------------------- dispatch
    def _foreign(self, tensors) -> bool:
        if self.fake_mode is None:
            return False
        return any(getattr(t, "fake_mode", self.fake_mode)
                   is not self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented              # its local ops come back here
        if _propagating() or self._foreign(ins):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if (packet not in self._registry
                and func is not torch.ops.prim.device.default):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if self._foreign(outs) or func is torch.ops.prim.device.default:
            return out
        for o in outs:
            self._hold(o)
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns in _COLL_NAMESPACES:
            if name in COLLECTIVES:
                self.rows.append(Row(name, sum(map(nbytes, ins)), 0, 0,
                                     COLLECTIVES[name]))
            return out
        if _is_view(func):
            return out
        flops = 0
        if packet in self._registry:
            flops = int(self._registry[packet](*args, **kwargs, out_val=out))
        self.rows.append(Row(str(packet), sum(map(nbytes, ins)),
                             sum(map(nbytes, outs)), flops))
        return out


class _NoModules:
    """A module tracker that tracks none: every count goes to "Global"."""
    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def flop_counter():
    """``torch.utils.flop_counter.FlopCounterMode`` with its module tracker
    off: the same registry and the same count (``get_total_flops``), but no
    backward hooks on modules, which refuse an ``autograd.grad`` taken
    inside a module's forward (as ``train_step.value_and_grad`` takes it)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _NoModules()
    return counter


def collective_bytes(rows) -> dict:
    """Return {'total': int, 'count': int, 'by_op': {op: bytes},
    'by_op_count': {op: n}} over a :class:`Recorder`'s rows."""
    by_op: dict[str, int] = defaultdict(int)
    by_op_count: dict[str, int] = defaultdict(int)
    for r in rows:
        if r.collective is not None:
            by_op[r.collective] += r.in_bytes
            by_op_count[r.collective] += 1
    return {
        "total": int(sum(by_op.values())),
        "count": int(sum(by_op_count.values())),
        "by_op": {k: int(v) for k, v in sorted(by_op.items())},
        "by_op_count": {k: int(v) for k, v in sorted(by_op_count.items())},
    }
