"""The port's declarative topology API, mirroring ``tests/test_topology.py``:
spec validation (each rejection also rejected by the reference), the one
``resolve()`` construction point, the raw-mesh deprecation shim (bitwise
the spec path), and the degenerate single-process host mesh — held to the
reference's ``repro.api.fit`` under the jax-replay key tree where a fit
runs.

The port's meshes are :class:`repro_torch.engine.topology.DeviceMesh`
objects whose positions are dealt round-robin over the devices of the run
(here the CPU), so a mesh of any size builds on one device.
"""
import warnings

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.data.synthetic import GMMSpec as JGMMSpec, gmm_dataset
from repro_torch.api import BigMeansConfig, TopologySpec, fit
from repro_torch.engine import topology as topo
from test_torch_rng import REPLAY

X = np.asarray(gmm_dataset(JGMMSpec(m=2000, n=5, components=4, seed=3)))
CFG = BigMeansConfig(k=4, s=64, n_chunks=8, log_every=0, impl="ref")
JCFG = japi.BigMeansConfig(k=4, s=64, n_chunks=8, log_every=0, impl="ref")
CPU = torch.device("cpu")
RTOL = 1e-5


def cpu_mesh(shape, axes):
    return topo.make_mesh(shape, axes, "cpu")


def legacy(cfg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# TopologySpec validation
# ---------------------------------------------------------------------------


def test_spec_defaults_and_kinds():
    from repro.engine import topology as jtopo

    assert TopologySpec().kind == "auto"
    assert topo.KINDS == jtopo.KINDS
    for kind in topo.KINDS:
        if kind == "host_mesh":
            assert TopologySpec(kind=kind, hosts=2, rank=0).hosts == 2
        elif kind in ("auto", "single"):
            TopologySpec(kind=kind)
        else:
            TopologySpec(kind=kind, devices=1)


@pytest.mark.parametrize("bad", [
    dict(kind="bogus"),
    dict(kind="single", devices=2),
    dict(kind="host_mesh", devices=2),
    dict(kind="worker_mesh", devices=0),
    dict(kind="worker_mesh", devices=(2, 2), axes=("data",)),
    dict(kind="worker_mesh", axes=("",)),
    dict(kind="stream_mesh", hosts=2),
    dict(kind="single", coordinator="h:1"),
    dict(kind="host_mesh", hosts=0),
    dict(kind="host_mesh", rank=-1),
    dict(kind="host_mesh", sync_timeout_s=0),
    dict(kind="worker_mesh", devices="four"),
    dict(kind="host_mesh", straggler_s=-1.0),
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_spec_rejects(bad):
    with pytest.raises(ValueError):
        TopologySpec(**bad)
    with pytest.raises(ValueError):
        japi.TopologySpec(**bad)


def test_as_spec_coercion():
    assert topo.as_spec("single").kind == "single"
    spec = TopologySpec(kind="stream_mesh", devices=1)
    assert topo.as_spec(spec) is spec
    with pytest.raises(TypeError):
        topo.as_spec(42)
    with pytest.raises(ValueError):
        topo.as_spec("not_a_kind")


# ---------------------------------------------------------------------------
# resolve(): the one mesh construction point
# ---------------------------------------------------------------------------


def test_resolve_kinds():
    assert isinstance(topo.resolve("single"), topo.SingleDevice)
    assert isinstance(topo.resolve("auto"), topo.SingleDevice)
    sm = topo.resolve(TopologySpec(kind="stream_mesh", devices=1),
                      device="cpu")
    assert isinstance(sm, topo.StreamMesh) and sm.axis == "streams"
    wm = topo.resolve(TopologySpec(kind="worker_mesh", devices=1),
                      role="worker", device="cpu")
    assert isinstance(wm, topo.WorkerMesh) and wm.axes == ("data",)
    auto_w = topo.resolve("auto", role="worker", device="cpu")
    assert isinstance(auto_w, topo.WorkerMesh)
    assert auto_w.devices == topo._local_device_count("cpu") == 1


def test_resolve_host_mesh_degenerate(monkeypatch):
    """hosts=1 (or nothing set) is the no-bootstrap single-process group."""
    monkeypatch.delenv("REPRO_NUM_HOSTS", raising=False)
    hm = topo.resolve("host_mesh")
    assert isinstance(hm, topo.HostMesh)
    assert (hm.processes, hm.rank) == (1, 0)


def test_worker_mesh_validates_axes_at_construction():
    mesh = cpu_mesh((1,), ("data",))
    with pytest.raises(ValueError, match="'bogus'.*data"):
        topo.WorkerMesh(mesh, ("bogus",))
    with pytest.raises(ValueError, match="at least one"):
        topo.WorkerMesh(mesh, ())
    with pytest.raises(ValueError, match="'nope'"):
        topo.StreamMesh(mesh, "nope")
    # valid axes still construct
    assert topo.WorkerMesh(mesh, ("data",)).devices == 1


def test_host_mesh_descriptor_validation():
    with pytest.raises(ValueError):
        topo.HostMesh(processes=0, rank=0)
    with pytest.raises(ValueError):
        topo.HostMesh(processes=2, rank=2)
    assert topo.HostMesh(processes=2, rank=1).devices == 2


def test_requested_kind_and_worker_count():
    assert topo.requested_kind(CFG) == "auto"
    cfg = CFG.replace(topology=TopologySpec(kind="worker_mesh", devices=3))
    assert topo.requested_kind(cfg) == "worker_mesh"
    assert topo.worker_count(cfg) == 3
    cfg = CFG.replace(topology=TopologySpec(kind="worker_mesh",
                                            devices=(2, 2),
                                            axes=("data", "model")))
    assert topo.worker_count(cfg) == 4
    leg = legacy(CFG, mesh=cpu_mesh((1,), ("data",)))
    assert topo.requested_kind(leg) == "legacy_mesh"
    assert topo.worker_count(leg) == 1
    assert topo.worker_count(CFG, "cpu") == 1


# ---------------------------------------------------------------------------
# DeviceMesh: the port's mesh
# ---------------------------------------------------------------------------


def test_device_mesh_deals_positions_round_robin(monkeypatch):
    """make_mesh deals the positions over the devices it is given (every
    card for a CUDA run, the CPU for a CPU run), so W workers share a
    device; a malformed mesh is refused."""
    mesh = cpu_mesh((4, 2), ("data", "model"))
    assert mesh.size == 8 and set(mesh.devices) == {CPU}
    assert mesh.axis_size("model") == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = topo.make_mesh((5,), ("data",))
    assert [d.index for d in mesh.devices] == [0, 1, 2, 0, 1]
    assert set(topo.make_mesh((2,), ("data",), "cuda:1").devices) == {
        torch.device("cuda", 1)}
    for bad in (dict(shape=(2,), axis_names=("a", "b"), devices=["cpu"] * 2),
                dict(shape=(2,), axis_names=("a",), devices=["cpu"]),
                dict(shape=(0,), axis_names=("a",), devices=[]),
                dict(shape=(1, 1), axis_names=("a", "a"), devices=["cpu"])):
        with pytest.raises(ValueError):
            topo.DeviceMesh(**bad)


def test_worker_devices_follow_the_reference_worker_index():
    """Worker ``widx = i * shape[1] + j`` on a two-axis worker mesh
    (reference ``incore.py:260-266``) sits at mesh position (i, j); on a
    mesh it spans only in part, at index 0 on the other axes."""
    mesh = topo.DeviceMesh((3, 2), ("data", "model"),
                           [torch.device("cuda", i) for i in range(6)])

    def idx(axes):
        return [d.index for d in topo.WorkerMesh(mesh, axes).worker_devices()]

    assert idx(("data", "model")) == [0, 1, 2, 3, 4, 5]
    assert idx(("data",)) == [0, 2, 4]
    assert idx(("model",)) == [0, 1]
    assert idx(("model", "data")) == [0, 2, 4, 1, 3, 5]
    sm = topo.StreamMesh(topo.DeviceMesh(
        (2,), ("streams",), [torch.device("cuda", i) for i in (1, 0)]))
    assert [d.index for d in sm.group_devices()] == [1, 0]


def test_no_card_means_no_mesh(monkeypatch):
    """A mesh asked for on the card, with no card present, raises; it is
    never built on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topo.make_mesh((4,), ("data",))
    cfg = CFG.replace(topology=TopologySpec(kind="worker_mesh", devices=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(X, cfg, method="sharded")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(X, CFG.replace(batch=4, topology="stream_mesh"))


# ---------------------------------------------------------------------------
# config integration: the primary path is declarative, raw mesh is shimmed
# ---------------------------------------------------------------------------


def test_config_normalizes_topology_to_spec():
    cfg = CFG.replace(topology="host_mesh")
    assert isinstance(cfg.topology, TopologySpec)
    assert cfg.topology.kind == "host_mesh"
    with pytest.raises(ValueError):
        CFG.replace(topology="bogus")
    with pytest.raises(TypeError):
        CFG.replace(topology=7)


def test_raw_mesh_deprecated_but_working():
    mesh = cpu_mesh((1,), ("streams",))
    with pytest.warns(DeprecationWarning, match="topology"):
        cfg = CFG.replace(mesh=mesh, stream_axis="streams")
    assert cfg.mesh is mesh                     # shim: still carried through
    with pytest.raises(TypeError, match="DeviceMesh"):
        CFG.replace(mesh=object())


def test_raw_mesh_conflicts_with_explicit_topology():
    mesh = cpu_mesh((1,), ("streams",))
    with pytest.raises(ValueError, match="mutually exclusive"):
        legacy(CFG, mesh=mesh, topology="stream_mesh")


def test_shim_and_spec_bit_identical_streaming():
    """A raw cfg.mesh and the equivalent declarative spec give the same
    fit, bit for bit (here over two stream groups)."""
    mesh = cpu_mesh((2,), ("streams",))
    leg = legacy(CFG, mesh=mesh, stream_axis="streams", batch=2)
    spec = CFG.replace(batch=2, topology=TopologySpec(
        kind="stream_mesh", devices=2, axes=("streams",)))
    r_legacy = fit(X, leg, method="streaming", device="cpu")
    r_spec = fit(X, spec, method="streaming", device="cpu")
    assert r_legacy.objective == r_spec.objective
    assert torch.equal(r_legacy.centroids, r_spec.centroids)
    assert r_legacy.n_accepted == r_spec.n_accepted


def test_shim_and_spec_bit_identical_batched():
    mesh = cpu_mesh((2,), ("streams",))
    leg = legacy(CFG, mesh=mesh, stream_axis="streams", batch=4)
    spec = CFG.replace(batch=4, topology=TopologySpec(
        kind="stream_mesh", devices=2, axes=("streams",)))
    r_legacy = fit(X, leg, method="batched", device="cpu")
    r_spec = fit(X, spec, method="batched", device="cpu")
    assert r_legacy.objective == r_spec.objective
    assert torch.equal(r_legacy.centroids, r_spec.centroids)
    assert r_legacy.trace == r_spec.trace


def test_batched_rejects_worker_topology():
    cfg = CFG.replace(topology=TopologySpec(kind="worker_mesh", devices=1),
                      batch=2)
    with pytest.raises(ValueError, match="batched"):
        fit(X, cfg, method="batched", device="cpu")


def test_sharded_consumes_spec():
    cfg = CFG.replace(topology=TopologySpec(kind="worker_mesh", devices=1))
    r = fit(X, cfg, method="sharded", device="cpu")
    assert r.extras["workers"] == 1


def test_auto_routes_host_mesh_to_streaming(monkeypatch):
    from repro_torch.api import strategies as S
    from repro_torch.api.sources import as_source

    monkeypatch.delenv("REPRO_NUM_HOSTS", raising=False)
    cfg = CFG.replace(topology="host_mesh")
    assert S.resolve_auto(cfg, as_source(X), CPU) == "streaming"


def test_stream_loop_rejects_meshless_placements():
    """The stream loop takes no worker mesh, no host mesh without the
    exchanger, and no ``competitive_s`` over a stream mesh (reference
    ``stream.py:352-361,375-380``)."""
    from repro_torch.engine import stream

    def provider(cid):
        return X[:64]

    cases = [(CFG, topo.WorkerMesh(cpu_mesh((1,), ("data",)))),
             (CFG, topo.HostMesh(processes=1, rank=0)),
             (CFG.replace(batch=2, scheduler="competitive_s"),
              topo.StreamMesh(cpu_mesh((2,), ("streams",))))]
    for cfg, placement in cases:
        with pytest.raises(ValueError):
            stream.run_stream(provider, cfg, n_features=5,
                              topology=placement, device="cpu")


def test_single_process_host_mesh_matches_plain_streaming(monkeypatch):
    """topology='host_mesh' with hosts=1 is the degenerate group: no store,
    and results bitwise plain streaming — which takes the reference's
    decisions (the reference's host-mesh fit of the same config)."""
    monkeypatch.delenv("REPRO_NUM_HOSTS", raising=False)
    cfg = CFG.replace(batch=4)
    r_plain = fit(X, cfg, method="streaming", device="cpu", rng=REPLAY)
    r_host = fit(X, cfg.replace(topology="host_mesh"), method="streaming",
                 device="cpu", rng=REPLAY)
    assert r_plain.objective == r_host.objective
    assert torch.equal(r_plain.centroids, r_host.centroids)
    assert r_plain.n_accepted == r_host.n_accepted
    assert r_host.extras["host"]["processes"] == 1
    ranks = r_host.extras["health"]["ranks"]
    assert len(ranks) == 1 and ranks[0]["rank"] == 0
    want = japi.fit(X, JCFG.replace(batch=4, topology="host_mesh"),
                    method="streaming")
    assert r_host.n_accepted == want.n_accepted
    assert r_host.n_iterations == want.n_iterations
    assert r_host.extras["host"] == want.extras["host"]
    assert r_host.extras["health"]["ranks"] == want.extras["health"]["ranks"]
    np.testing.assert_allclose(r_host.objective, want.objective, rtol=RTOL)
