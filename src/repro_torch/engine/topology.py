"""Topology — *where* the chunk streams advance.

The reference's ``repro.engine.topology``: a small frozen descriptor the
engine dispatches on, with the chunk steps reused unchanged in every
placement:

* :class:`SingleDevice` — all streams on one device (batched or scalar).
* :class:`StreamMesh` — the B streams of the batched step split into D
  groups over a 1-axis device mesh; every group advances on its device and
  the periodic exchange is an argmin over all streams.
* :class:`WorkerMesh` — one independent chunk stream per worker of a mesh
  (the sharded strategy); the exchange is an argmin over the workers.
* :class:`HostMesh` — one process per host, each owning a disjoint shard of
  the chunk-id stream; incumbents are exchanged at sync windows through a
  ``torch.distributed.TCPStore`` (:mod:`repro_torch.engine.hostmesh`).

A declarative :class:`TopologySpec` (``BigMeansConfig.topology``) names the
placement and :func:`resolve` — the one place device meshes are built —
turns it into a descriptor.  A raw ``cfg.mesh`` (a :class:`DeviceMesh`)
still works through :func:`from_config`'s deprecation shim, bitwise the
spec path.

:class:`DeviceMesh` takes the place of ``jax.sharding.Mesh``: a shape,
axis names and one ``torch.device`` per mesh position, row-major.  Devices
may repeat.  The reference's ``make_mesh`` refuses more positions than
devices; :func:`make_mesh` here deals the positions round-robin over the
devices it is given, so W workers share one card (or the CPU) and run one
after another in worker order.  Each worker's chunk stream depends only on
its key and its row shard, so the results are those of W devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

KINDS = ("auto", "single", "stream_mesh", "worker_mesh", "host_mesh")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A device mesh: ``shape`` over ``axis_names``, one device per
    position in row-major order (repeats allowed)."""

    shape: tuple
    axis_names: tuple
    devices: tuple

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(
                f"mesh shape {self.shape} and axes {self.axis_names} must "
                "have the same length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes repeat: {self.axis_names}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"mesh shape must be positive, got {self.shape}")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(
                f"mesh of shape {self.shape} needs {math.prod(self.shape)} "
                f"devices, got {len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def device_at(self, coords: dict) -> torch.device:
        """The device at the position with ``coords`` (axis -> index; the
        axes not named are at 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.shape):
            flat = flat * size + int(coords.get(name, 0))
        return self.devices[flat]


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A :class:`DeviceMesh` of ``shape`` over ``axes`` whose positions are
    dealt round-robin over the devices of ``device``: every CUDA card for
    ``None`` or ``"cuda"``, the one card of ``"cuda:i"``, the CPU for
    ``"cpu"``."""
    shape = tuple(int(s) for s in shape)
    pool = _device_pool(device)
    n = math.prod(shape)
    return DeviceMesh(shape, tuple(axes),
                      tuple(pool[i % len(pool)] for i in range(n)))


def _device_pool(device=None) -> list:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return [torch.device("cuda", i) for i in range(count)]
    return [dev]


def check_axes(mesh, axes) -> None:
    """Every name in ``axes`` must be an axis of ``mesh`` — validated at
    descriptor construction, so a typo fails here with the mesh's real axis
    names."""
    known = tuple(mesh.axis_names)
    missing = [a for a in axes if a not in known]
    if missing:
        raise ValueError(
            f"axes {missing} not in mesh (mesh axes: {known})")


@dataclasses.dataclass(frozen=True)
class SingleDevice:
    name: str = dataclasses.field(default="single", init=False)

    @property
    def devices(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """Split the stream (batch) axis of the batched step over ``mesh``."""

    mesh: Any
    axis: str = "streams"
    name: str = dataclasses.field(default="stream_mesh", init=False)

    def __post_init__(self):
        check_axes(self.mesh, (self.axis,))

    @property
    def devices(self) -> int:
        return int(self.mesh.axis_size(self.axis))

    def group_devices(self) -> list:
        """The device of each stream group, in group order."""
        return [self.mesh.device_at({self.axis: g})
                for g in range(self.devices)]


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """One chunk stream per position of the ``axes`` mesh axes."""

    mesh: Any
    axes: tuple = ("data",)
    name: str = dataclasses.field(default="worker_mesh", init=False)

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple(self.axes))
        if not self.axes:
            raise ValueError("WorkerMesh needs at least one mesh axis")
        check_axes(self.mesh, self.axes)

    @property
    def devices(self) -> int:
        w = 1
        for a in self.axes:
            w *= int(self.mesh.axis_size(a))
        return w

    def worker_devices(self) -> list:
        """The device of each worker in worker order: worker ``widx`` is
        the row-major index over ``axes`` (the reference's
        ``widx = i * shape[1] + j``), at index 0 on the other axes."""
        sizes = [self.mesh.axis_size(a) for a in self.axes]
        out = []
        for widx in range(self.devices):
            coords, rest = {}, widx
            for a, size in zip(reversed(self.axes), reversed(sizes)):
                coords[a] = rest % size
                rest //= size
            out.append(self.mesh.device_at(coords))
        return out


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """One process per host; each rank owns a disjoint shard of the
    chunk-id stream and exchanges incumbents at sync windows (see
    :mod:`repro_torch.engine.hostmesh`)."""

    processes: int
    rank: int
    sync_timeout_s: float = 60.0
    straggler_s: float = 5.0
    name: str = dataclasses.field(default="host_mesh", init=False)

    def __post_init__(self):
        if self.processes < 1:
            raise ValueError(f"processes must be >= 1, got {self.processes}")
        if not 0 <= self.rank < self.processes:
            raise ValueError(
                f"rank {self.rank} out of range for {self.processes} "
                "processes")

    @property
    def devices(self) -> int:
        return self.processes


Topology = SingleDevice | StreamMesh | WorkerMesh | HostMesh


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Declarative placement: *what* topology, not *how* to build it.

    * ``kind`` — ``'auto'`` (strategy picks), ``'single'``,
      ``'stream_mesh'``, ``'worker_mesh'``, ``'host_mesh'``.
    * ``devices`` — mesh positions (int; 1-axis meshes) or a full mesh
      shape tuple (``worker_mesh`` multi-axis); ``None`` = one per local
      device.
    * ``axes`` — mesh axis names; defaults: ``('streams',)`` for
      ``stream_mesh``, ``('data',)`` for ``worker_mesh``.
    * ``hosts`` / ``coordinator`` / ``rank`` — ``host_mesh`` bootstrap
      (``None`` reads the ``REPRO_NUM_HOSTS`` / ``REPRO_COORD`` /
      ``REPRO_HOST_RANK`` environment, the launcher contract of
      :func:`repro_torch.engine.hostmesh.launch_local`).
    * ``sync_timeout_s`` — how long a rank waits at an exchange window for
      its peers before the run fails with a typed
      :class:`repro_torch.engine.faults.HostDead` (never a hang).
    * ``straggler_s`` — gather wall time above this emits a
      ``('host_straggler', window, seconds)`` trace event.
    """

    kind: str = "auto"
    devices: Any = None
    axes: tuple = ()
    hosts: int | None = None
    coordinator: str | None = None
    rank: int | None = None
    sync_timeout_s: float = 60.0
    straggler_s: float = 5.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown topology kind {self.kind!r}; known: {KINDS}")
        object.__setattr__(self, "axes", tuple(self.axes))
        for a in self.axes:
            if not isinstance(a, str) or not a:
                raise ValueError(
                    f"axes must be non-empty strings, got {a!r}")
        d = self.devices
        if d is not None:
            if isinstance(d, int) and not isinstance(d, bool):
                if d < 1:
                    raise ValueError(f"devices must be >= 1, got {d}")
            elif isinstance(d, (tuple, list)):
                object.__setattr__(self, "devices", tuple(int(x) for x in d))
                if not self.devices or any(x < 1 for x in self.devices):
                    raise ValueError(
                        f"devices shape must be positive ints, got {d!r}")
                if self.axes and len(self.devices) != len(self.axes):
                    raise ValueError(
                        f"devices shape {self.devices} and axes {self.axes} "
                        "must have the same length")
            else:
                raise ValueError(
                    f"devices must be an int, a shape tuple or None, "
                    f"got {d!r}")
        if self.hosts is not None and (
                not isinstance(self.hosts, int) or self.hosts < 1):
            raise ValueError(f"hosts must be a positive int, got {self.hosts!r}")
        if self.rank is not None and (
                not isinstance(self.rank, int) or self.rank < 0):
            raise ValueError(f"rank must be an int >= 0, got {self.rank!r}")
        if self.sync_timeout_s <= 0 or self.straggler_s <= 0:
            raise ValueError("sync_timeout_s and straggler_s must be positive")
        if self.kind != "host_mesh" and (
                self.hosts is not None or self.coordinator is not None
                or self.rank is not None):
            raise ValueError(
                "hosts/coordinator/rank only apply to kind='host_mesh', "
                f"got kind={self.kind!r}")
        if self.kind in ("single", "host_mesh") and self.devices is not None:
            raise ValueError(
                f"kind={self.kind!r} takes no devices field (use hosts for "
                "host_mesh)")


def as_spec(value) -> TopologySpec:
    """Coerce ``'single'``-style kind strings to a :class:`TopologySpec`."""
    if isinstance(value, TopologySpec):
        return value
    if isinstance(value, str):
        return TopologySpec(kind=value)
    raise TypeError(
        f"topology must be a kind string {KINDS} or a TopologySpec, "
        f"got {type(value).__name__}")


def _local_device_count(device=None) -> int:
    """Devices a run on ``device`` sees: every CUDA card for a CUDA run
    (``None`` included), 1 for ``device="cpu"`` or one named card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return 1
    return torch.cuda.device_count()


def resolve(spec, *, role: str = "stream", device=None) -> Topology:
    """The single place topology specs become concrete descriptors (and
    the single place device meshes are built, over the devices of
    ``device``: see :func:`make_mesh`).

    ``role`` disambiguates ``'auto'``: the stream loop defaults to one
    device, the sharded strategy to a worker mesh over every local device.
    """
    spec = as_spec(spec)
    kind = spec.kind
    if kind == "auto":
        kind = "worker_mesh" if role == "worker" else "single"
    if kind == "single":
        if role == "worker":    # sharded strategy forced onto one device
            axes = spec.axes or ("data",)
            return WorkerMesh(make_mesh((1,), axes, device), axes)
        return SingleDevice()
    if kind == "stream_mesh":
        axis = spec.axes[0] if spec.axes else "streams"
        ndev = spec.devices if isinstance(spec.devices, int) \
            else _local_device_count(device)
        return StreamMesh(make_mesh((ndev,), (axis,), device), axis)
    if kind == "worker_mesh":
        axes = spec.axes or ("data",)
        if isinstance(spec.devices, tuple):
            shape = spec.devices
        else:
            ndev = spec.devices if isinstance(spec.devices, int) \
                else _local_device_count(device)
            if len(axes) > 1:
                raise ValueError(
                    f"worker_mesh with axes {axes} needs devices as a "
                    "matching shape tuple")
            shape = (ndev,)
        return WorkerMesh(make_mesh(shape, axes, device), axes)
    # host_mesh: join (or create) the process group's store
    from repro_torch.engine import hostmesh

    processes, rank = hostmesh.bootstrap(spec)
    return HostMesh(processes=processes, rank=rank,
                    sync_timeout_s=spec.sync_timeout_s,
                    straggler_s=spec.straggler_s)


def requested_kind(cfg) -> str:
    """The placement a config asks for, without constructing anything.

    ``'legacy_mesh'`` when a raw ``cfg.mesh`` is set (the deprecated path);
    otherwise the spec's kind verbatim (``'auto'`` included).
    """
    if getattr(cfg, "mesh", None) is not None:
        return "legacy_mesh"
    return as_spec(getattr(cfg, "topology", "auto")).kind


def worker_count(cfg, device=None) -> int:
    """How many workers a sharded run of this config would use — from the
    legacy mesh, the spec's devices field, or the local device count."""
    mesh = getattr(cfg, "mesh", None)
    if mesh is not None:
        return int(mesh.size)
    spec = as_spec(getattr(cfg, "topology", "auto"))
    if isinstance(spec.devices, int):
        return spec.devices
    if isinstance(spec.devices, tuple):
        return math.prod(spec.devices)
    return _local_device_count(device)


def from_config(cfg, role: str = "stream", device=None) -> Topology:
    """Topology for a config: the spec path through :func:`resolve`, or the
    raw-mesh deprecation shim (``cfg.mesh`` wrapped as the reference's
    legacy strategies did — ``StreamMesh(mesh, cfg.stream_axis)`` for the
    stream loop, ``WorkerMesh(mesh, mesh.axis_names)`` for the sharded
    strategy — so shimmed runs are bitwise spec runs on the same mesh)."""
    mesh = getattr(cfg, "mesh", None)
    if mesh is not None:
        if role == "worker":
            return WorkerMesh(mesh, tuple(mesh.axis_names))
        return StreamMesh(mesh, getattr(cfg, "stream_axis", "streams"))
    return resolve(getattr(cfg, "topology", "auto"), role=role,
                   device=device)


def for_streams(cfg, device=None) -> Topology:
    """Stream-parallel topology from a config (the stream loop's default)."""
    return from_config(cfg, role="stream", device=device)


def for_workers(cfg, mesh=None, device=None) -> WorkerMesh:
    if mesh is not None:
        return WorkerMesh(mesh, tuple(mesh.axis_names))
    topo = from_config(cfg, role="worker", device=device)
    if not isinstance(topo, WorkerMesh):
        raise ValueError(
            f"worker topology needs a device mesh, got {topo.name}")
    return topo
