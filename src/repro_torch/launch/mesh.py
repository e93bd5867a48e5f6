"""Meshes of the dry run, the reference's ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh``.  The production meshes
are 16 x 16 ``("data", "model")`` (256 cards) and 2 x 16 x 16 ``("pod",
"data", "model")`` (512); the dry run builds them over a *fake* process
group (:func:`fake_world`: torch's ``FakeStore`` and ``"fake"`` backend,
this process rank 0), whose collectives return at once and move nothing,
in place of the reference's 512 placeholder XLA host devices.

Everything here is a function: importing the module starts no process
group.  A process holds one world at a time, and :func:`fake_world` tears
its down when the ``with`` ends, on error too, so a 256-rank world never
outlives its caller (a test's neighbours on the same worker see none).
The sharding rules read a mesh through ``train.sharding.MeshView``.
``repro_torch.engine.topology.DeviceMesh`` (the clustering's worker
positions on the run's devices) is another object.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process ``rank``
    (0: the dry run counts rank 0's work), for the ``with``; destroyed when
    it ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry run needs a world of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0..n-1 of
    the running world, on ``device_type`` (``"cuda"`` or ``"cpu"``)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() < n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"mesh {shape} needs a world of {n} ranks, found {have}: run "
            "inside fake_world(n) (the dry run does)")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type)


def make_host_mesh(shape=None, axes=("data", "model"),
                   device_type: str | None = None):
    """A mesh over the running world's real devices (one rank a device;
    the caller initialized the process group): ``(world, 1)`` unless
    ``shape`` is given."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group, one rank a device")
    if shape is None:
        shape = (dist.get_world_size(), 1)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return make_mesh(shape, axes, device_type)
