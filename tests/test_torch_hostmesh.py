"""The port's multi-host streaming (``repro_torch.engine.hostmesh``).

The exchanger's mechanics (shard math, the argmin tie-break, counter
deltas, straggler and dead-peer events, the composition checks) mirror the
unit tests of ``tests/test_hostmesh.py`` on a fake runtime, and the
runtime's gathers, barriers and timeouts run against a real
``torch.distributed.TCPStore`` in this process.  Real two-process runs go
through the port's :func:`~repro_torch.engine.hostmesh.launch_local`: each
rank is a small script that imports torch and the port only (never jax),
prints a ``RESULT`` JSON line, and must be bitwise the port's
single-process run of the same config — in fold mode (``sync_every=1``)
and in persistent mode (``sync_every=2``).  A rank killed before its first
exchange gives its peer a typed ``HostDead`` at window 0, not a hang.
Every launch carries its own time limit.
"""
import datetime
import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.api import BigMeansConfig, fit
from repro_torch.engine import hostmesh
from repro_torch.engine.faults import HostDead
from repro_torch.engine.stream import RunnerMetrics
from repro_torch.engine.topology import HostMesh, TopologySpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = BigMeansConfig(k=4, s=64, n_chunks=8, batch=4, log_every=0,
                     impl="ref", prefetch=2)


def _provider(cid):
    """Pure in chunk id — every process regenerates identical chunks."""
    rng = np.random.default_rng((11, cid))
    return rng.normal(size=(64, 5)).astype(np.float32)


# ---------------------------------------------------------------------------
# exchanger unit tests (fake runtime, no store)
# ---------------------------------------------------------------------------


class _FakeRuntime:
    def __init__(self, processes=2, rank=0, gathered=None, raise_dead=False):
        self.processes = processes
        self.rank = rank
        self._gathered = gathered
        self._raise = raise_dead

    def allgather(self, tag, payload):
        if self._raise:
            raise HostDead("rank 1 missed exchange", rank=self.rank)
        return self._gathered


def _ctx():
    return types.SimpleNamespace(metrics=RunnerMetrics(), last_s=64,
                                 extras={})


def test_chunk_id_sharding_preserves_global_window_order():
    ex0 = hostmesh.HostExchanger(_FakeRuntime(2, 0), CFG)
    ex1 = hostmesh.HostExchanger(_FakeRuntime(2, 1), CFG)
    assert list(ex0.chunk_ids(0)) == [0, 1, 4, 5]
    assert list(ex1.chunk_ids(0)) == [2, 3, 6, 7]
    # the union per window is contiguous: window w covers w*B..w*B+B-1
    assert sorted(list(ex0.chunk_ids(0)) + list(ex1.chunk_ids(0))) == \
        list(range(8))
    # resume from a window frontier drops exactly the finished windows
    assert list(ex0.chunk_ids(4)) == [4, 5]
    assert list(ex1.chunk_ids(4)) == [6, 7]


def test_winner_argmin_breaks_ties_toward_lowest_rank():
    g = [{"f": np.float32(8.0), "size": np.int64(64)},
         {"f": np.float32(8.0), "size": np.int64(64)}]
    assert hostmesh.HostExchanger._winner(g) == 0
    g[1]["f"] = np.float32(7.0)
    assert hostmesh.HostExchanger._winner(g) == 1
    # per-point comparison: a smaller raw f on a smaller chunk can lose
    g = [{"f": np.float32(10.0), "size": np.int64(100)},
         {"f": np.float32(6.0), "size": np.int64(50)}]
    assert hostmesh.HostExchanger._winner(g) == 0


def test_counter_delta_merge_is_exactly_once():
    ex = hostmesh.HostExchanger(_FakeRuntime(2, 0), CFG)
    ex._counters = (10, 100.0)
    acc, nd = ex._merge_counters([
        {"acc": np.int64(14), "nd": np.float64(130.0)},
        {"acc": np.int64(13), "nd": np.float64(120.0)},
    ])
    assert (acc, nd) == (17, 150.0)
    assert ex._counters == (17, 150.0)


def test_straggler_gather_is_traced():
    ticks = iter([0.0, 9.0])
    ex = hostmesh.HostExchanger(
        _FakeRuntime(2, 0, gathered=[{}, {}]), CFG,
        straggler_s=5.0, clock=lambda: next(ticks))
    ctx = _ctx()
    ex._gather(ctx, "x0", {}, 0)
    assert ("host_straggler", 0, 9.0) in ctx.metrics.trace


def test_dead_peer_enriches_typed_fault():
    ex = hostmesh.HostExchanger(_FakeRuntime(2, 0, raise_dead=True), CFG)
    ctx = _ctx()
    ctx.metrics.chunks_done = 2
    with pytest.raises(HostDead) as ei:
        ex._gather(ctx, "x3", {}, 3)
    assert ei.value.window == 3
    assert ei.value.health["chunks_done"] == 2
    assert ei.value.health["chunks_fetched"] == 2
    assert any(t[0] == "host_dead" and t[1] == 3
               for t in ctx.metrics.trace)


def test_run_host_stream_validates_composition():
    topo2 = HostMesh(processes=2, rank=0)
    with pytest.raises(ValueError, match="divide the global batch"):
        hostmesh.run_host_stream(_provider, CFG.replace(batch=3, n_chunks=9),
                                 topology=topo2, n_features=5, device="cpu")
    with pytest.raises(ValueError, match="divide n_chunks"):
        hostmesh.run_host_stream(_provider, CFG.replace(n_chunks=10),
                                 topology=topo2, n_features=5, device="cpu")
    with pytest.raises(ValueError, match="vns_ladder"):
        hostmesh.run_host_stream(_provider, CFG.replace(vns_ladder=(64,)),
                                 topology=topo2, n_features=5, device="cpu")
    with pytest.raises(ValueError, match="time_budget_s"):
        hostmesh.run_host_stream(_provider, CFG.replace(time_budget_s=5.0),
                                 topology=topo2, n_features=5, device="cpu")
    with pytest.raises(ValueError, match="competitive_s"):
        hostmesh.run_host_stream(
            _provider,
            CFG.replace(batch=2, scheduler="competitive_s", sync_every=4,
                        n_chunks=8),
            topology=topo2, n_features=5, device="cpu")


def test_env_names_match_the_reference():
    from repro.engine import hostmesh as jhostmesh

    for name in ("ENV_COORD", "ENV_NUM_HOSTS", "ENV_RANK"):
        assert getattr(hostmesh, name) == getattr(jhostmesh, name)


def test_launch_local_env_contract():
    script = ("import os, json; "
              "print('RESULT ' + json.dumps({"
              "'rank': os.environ['REPRO_HOST_RANK'], "
              "'hosts': os.environ['REPRO_NUM_HOSTS'], "
              "'coord': os.environ['REPRO_COORD']}))")
    procs = hostmesh.launch_local([sys.executable, "-c", script], 2,
                                  timeout_s=60)
    assert [p.returncode for p in procs] == [0, 0]
    outs = [json.loads(p.output.splitlines()[-1][len("RESULT "):])
            for p in procs]
    assert [o["rank"] for o in outs] == ["0", "1"]
    assert outs[0]["hosts"] == "2"
    assert outs[0]["coord"] == outs[1]["coord"]
    assert outs[0]["coord"].startswith("127.0.0.1:")


# ---------------------------------------------------------------------------
# the runtime on a real TCPStore (two ranks in this process)
# ---------------------------------------------------------------------------


def _stores(timeout_s=10.0):
    from torch.distributed import TCPStore

    port = hostmesh._free_port()
    td = datetime.timedelta(seconds=timeout_s)
    holder = {}

    def master():
        holder[0] = TCPStore("127.0.0.1", port, world_size=2,
                             is_master=True, timeout=td)

    t = threading.Thread(target=master)
    t.start()
    client = TCPStore("127.0.0.1", port, world_size=2, is_master=False,
                      timeout=td)
    t.join()
    return holder[0], client


def test_runtime_gathers_bitwise_and_times_out_typed():
    s0, s1 = _stores()
    rts = [hostmesh.HostRuntime(2, r, timeout_s=5.0, prefix="t", store=st)
           for r, st in enumerate((s0, s1))]
    payloads = [{"f": np.float32(r + 0.1), "C": np.arange(6, dtype=np.float32)
                 .reshape(2, 3) * np.float32(1.0 / 3.0) + r,
                 "d": np.array([True, r == 1])} for r in range(2)]
    got = [None, None]

    def run(r):
        got[r] = rts[r].allgather("w0", payloads[r])
        rts[r].barrier("b0")

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    for r in range(2):
        assert len(got[r]) == 2
        for g, p in zip(got[r], payloads):
            for k in p:
                np.testing.assert_array_equal(g[k], p[k])
                assert g[k].dtype == np.asarray(p[k]).dtype
    # a peer that never publishes: HostDead within the deadline
    rts[0].timeout_s = 0.5
    t0 = datetime.datetime.now()
    with pytest.raises(HostDead, match="rank 1 missed exchange 'w1'"):
        rts[0].allgather("w1", payloads[0])
    with pytest.raises(HostDead, match="barrier 'b1'"):
        rts[0].barrier("b1")
    assert (datetime.datetime.now() - t0).total_seconds() < 5.0
    # rank 0 leaves only once its peer has: no wait after the peer left
    rts[1].leave()
    rts[0].leave()


def test_pack_round_trips_bit_exactly():
    a = np.array([np.nan, -0.0, 1e-45, 3.4e38], dtype=np.float32)
    out = hostmesh._unpack(hostmesh._pack({"a": a, "i": np.int64(7)}))
    np.testing.assert_array_equal(out["a"].view(np.uint32), a.view(np.uint32))
    assert out["i"] == 7 and out["i"].dtype == np.int64


# ---------------------------------------------------------------------------
# real 2-process runs
# ---------------------------------------------------------------------------

_RANK_SCRIPT = r"""
import os, json, sys
import numpy as np

from repro_torch.api import BigMeansConfig, TopologySpec, fit

def provider(cid):
    rng = np.random.default_rng((11, cid))
    return rng.normal(size=(64, 5)).astype(np.float32)

spec = TopologySpec(kind="host_mesh", sync_timeout_s=60.0)
base = dict(k=4, s=64, n_chunks=8, batch=4, log_every=0, impl="ref",
            prefetch=2, topology=spec)

def record(r):
    return {"f": float(r.objective), "C": r.centroids.numpy().tolist(),
            "accepted": int(r.n_accepted), "iters": int(r.n_iterations)}

out = {}
r = fit(provider, BigMeansConfig(**base), method="streaming", n_features=5,
        device="cpu")
out["fold"] = dict(record(r), host=r.extras["host"],
                   ranks=r.extras["health"]["ranks"],
                   host_sync_windows=[t[1] for t in r.trace
                                      if t[0] == "host_sync"])
r2 = fit(provider, BigMeansConfig(**dict(base, sync_every=2)),
         method="streaming", n_features=5, device="cpu")
out["persistent"] = record(r2)
out["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                          for m in sys.modules)
print("RESULT " + json.dumps(out), flush=True)
"""

_KILLED_SCRIPT = r"""
import os, json, time
import numpy as np

from repro_torch.api import BigMeansConfig, TopologySpec, fit
from repro_torch.engine.faults import HostDead

rank = int(os.environ["REPRO_HOST_RANK"])

def provider(cid):
    # rank 1 dies on its first own chunk (after the collective start), so
    # rank 0 completes its window-0 chunks and then times out at the
    # exchange -- the typed-fault path with non-zero accounting
    if rank == 1 and cid in (2, 3):
        os._exit(3)
    rng = np.random.default_rng((11, cid))
    return rng.normal(size=(64, 5)).astype(np.float32)

spec = TopologySpec(kind="host_mesh", sync_timeout_s=8.0)
cfg = BigMeansConfig(k=4, s=64, n_chunks=8, batch=4, log_every=0,
                     impl="ref", prefetch=0, topology=spec)
t0 = time.monotonic()
try:
    fit(provider, cfg, method="streaming", n_features=5, device="cpu")
    out = {"host_dead": False}
except HostDead as e:
    out = {"host_dead": True, "rank": e.rank, "window": e.window,
           "health": e.health, "waited_s": time.monotonic() - t0}
print("RESULT " + json.dumps(out), flush=True)
"""


def _parse(proc):
    lines = [ln for ln in proc.output.splitlines()
             if ln.startswith("RESULT ")]
    assert lines, (proc.rank, proc.returncode, proc.output[-3000:])
    return json.loads(lines[-1][len("RESULT "):])


def _env():
    return {"PYTHONPATH": os.path.join(REPO, "src"),
            "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def two_proc():
    procs = hostmesh.launch_local(
        [sys.executable, "-c", _RANK_SCRIPT], 2, timeout_s=240,
        env_extra=_env())
    for p in procs:
        assert p.returncode == 0, (p.rank, p.output[-3000:])
    return [_parse(p) for p in procs]


@pytest.fixture(scope="module")
def single():
    """The port's single-process runs at the same global chunk budget."""
    return {"fold": fit(_provider, CFG, method="streaming", n_features=5,
                        device="cpu"),
            "persistent": fit(_provider, CFG.replace(sync_every=2),
                              method="streaming", n_features=5,
                              device="cpu")}


@pytest.mark.parametrize("mode", ["fold", "persistent"])
def test_two_process_bitwise_single(two_proc, single, mode):
    want = single[mode]
    for rank_out in two_proc:
        assert not rank_out["jax_imported"]
        got = rank_out[mode]
        assert got["f"] == want.objective
        np.testing.assert_array_equal(
            np.asarray(got["C"], dtype=np.float32), want.centroids.numpy())
        assert got["accepted"] == want.n_accepted
        assert got["iters"] == want.n_iterations


def test_two_process_health_and_sync_events(two_proc):
    for rank, out in enumerate(two_proc):
        assert out["fold"]["host"]["processes"] == 2
        assert out["fold"]["host"]["rank"] == rank
        ranks = out["fold"]["ranks"]
        assert [h["rank"] for h in ranks] == [0, 1]
        for h in ranks:
            assert h["chunks_done"] == 4            # 8 chunks over 2 ranks
            assert (h["chunks_done"] + h["chunks_failed"]
                    + h["chunks_dropped"] + h["chunks_quarantined"]
                    == h["chunks_fetched"])
        # collective sync: an exchange per window plus the final reduce
        assert out["fold"]["host_sync_windows"] == [0, 1, "final"]
    assert two_proc[0]["fold"]["ranks"] == two_proc[1]["fold"]["ranks"]


def test_killed_process_fails_fast_with_typed_fault():
    procs = hostmesh.launch_local(
        [sys.executable, "-c", _KILLED_SCRIPT], 2, timeout_s=240,
        env_extra=_env())
    dead = procs[1]
    assert dead.returncode == 3                 # rank 1 killed itself
    survivor = _parse(procs[0])
    assert procs[0].returncode == 0
    assert survivor["host_dead"] is True
    assert survivor["rank"] == 0
    assert survivor["window"] == 0              # the first exchange window
    assert survivor["waited_s"] < 60.0
    h = survivor["health"]
    assert h["chunks_done"] == 2                # rank 0's window-0 chunks
    assert (h["chunks_done"] + h["chunks_failed"] + h["chunks_dropped"]
            + h["chunks_quarantined"]) == h["chunks_fetched"]


def test_single_process_host_mesh_is_plain_streaming(monkeypatch, single):
    """hosts=1: no store, bitwise plain streaming, one rank's health."""
    monkeypatch.delenv("REPRO_NUM_HOSTS", raising=False)
    r = fit(_provider, CFG.replace(topology="host_mesh"), method="streaming",
            n_features=5, device="cpu")
    assert torch.equal(r.centroids, single["fold"].centroids)
    assert r.objective == single["fold"].objective
    assert r.extras["host"] == {"rank": 0, "processes": 1, "winner_rank": 0}
    assert hostmesh.bootstrap(TopologySpec(kind="host_mesh")) == (1, 0)
