"""The sharded strategy and the stream mesh: the port against the reference.

The reference runs once per module in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and ``impl="ref"``,
as ``tests/test_distributed.py`` does, at that file's sizes (m = 16,000,
n = 8, k = 5, s = 800): its worker-sharded windows on the ``(4, 2)`` mesh
over ``("data",)`` and over ``("data", "model")``, its stream-mesh batched
run, and ``fit(method="sharded")`` on a 4-worker mesh (uninterrupted and
under a time budget).  A recording middleware reads the per-worker state
stack after every window.  The port runs the same data on the CPU under
the jax-replay key tree, with the workers (and the stream groups) dealt
onto the one CPU device, so it must take every decision the reference
takes: the same accept sequence and Lloyd iterations per worker, the same
accepts per worker each window and the same incumbent after each exchange
(the winner's).  Objectives within ``RTOL``, centroids within
``rtol=atol=1e-4`` (the reference's own tolerance for the stream mesh,
``tests/test_distributed.py:51-56``).  The port's own compositions
(checkpoint / resume, the stream mesh against one device) are bitwise.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import BigMeansConfig, TopologySpec, fit
from repro_torch.api import strategies as S
from repro_torch.api.sources import as_source
from repro_torch.cluster import checkpoint as ckpt_lib
from repro_torch.core import big_means, big_means_batched, big_means_sharded
from repro_torch.core.objective import full_objective
from repro_torch.engine import incore
from repro_torch.engine import middleware as mw
from repro_torch.engine import stream
from repro_torch.engine import topology as topo
from test_torch_rng import REPLAY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
CTOL = 1e-4
K, S_, CPW, SYNC = 5, 800, 6, 2

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax
from repro.api import BigMeansConfig, TopologySpec, fit
from repro.core import big_means_batched
from repro.data.synthetic import GMMSpec, gmm_dataset
from repro.engine import incore, middleware as mw
from repro.launch.mesh import make_mesh

out_dir = sys.argv[1]
X = gmm_dataset(GMMSpec(m=16000, n=8, components=5, seed=2))
np.save(os.path.join(out_dir, "X.npy"), np.asarray(X))
key = jax.random.PRNGKey(0)
mesh = make_mesh((4, 2), ("data", "model"))


class Record(mw.Middleware):
    def __init__(self):
        self.windows = []

    def after_window(self, ctx):
        self.windows.append({
            "f_best": np.asarray(ctx.state.f_best).tolist(),
            "n_accepted": np.asarray(ctx.state.n_accepted).tolist(),
            "centroids": np.asarray(ctx.state.centroids[0]).tolist()})


def trace(infos):
    return {"f_new": np.asarray(infos.f_new).tolist(),
            "accepted": np.asarray(infos.accepted).tolist(),
            "lloyd_iters": np.asarray(infos.lloyd_iters).tolist()}


out = {}
for name, axes, cpw in (("data", ("data",), 6),
                        ("all", ("data", "model"), 4)):
    rec = Record()
    st, infos, ctx = incore.worker_sharded_rounds(
        X, key, mesh=mesh, k=5, s=800, chunks_per_worker=cpw, sync_every=2,
        axes=axes, impl="ref", middlewares=[rec])
    out[name] = dict(trace(infos), windows=rec.windows,
                     f_best=float(st.f_best),
                     n_accepted=int(st.n_accepted),
                     n_dist_evals=float(st.n_dist_evals),
                     centroids=np.asarray(st.centroids).tolist())

smesh = make_mesh((4,), ("streams",))
for name, m in (("local", None), ("stream_mesh", smesh)):
    st, infos = big_means_batched(X, key, k=5, s=800, batch=8, rounds=4,
                                  sync_every=2, impl="ref", mesh=m)
    out[name] = dict(trace(infos), f_best=float(st.f_best),
                     n_accepted=int(st.n_accepted),
                     centroids=np.asarray(st.centroids).tolist())

cfg = BigMeansConfig(k=5, s=800, n_chunks=24, sync_every=2, impl="ref",
                     topology=TopologySpec(kind="worker_mesh", devices=4))
for name, c in (("fit", cfg), ("budget", cfg.replace(time_budget_s=1e-9))):
    r = fit(X, c, method="sharded")
    out[name] = {"objective": r.objective, "n_accepted": r.n_accepted,
                 "n_chunks": r.n_chunks, "n_iterations": r.n_iterations,
                 "trace": r.trace, "centroids":
                 np.asarray(r.centroids).tolist(),
                 "extras": {k: v for k, v in r.extras.items()
                            if k in ("workers", "chunks_per_worker",
                                     "rounds_done")}}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(d)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    out["X"] = np.load(d / "X.npy")
    return out


class Record(mw.Middleware):
    """The per-worker state stack after every window."""

    def __init__(self):
        self.windows = []

    def after_window(self, ctx):
        self.windows.append({
            "f_best": ctx.state.f_best.tolist(),
            "n_accepted": ctx.state.n_accepted.tolist(),
            "centroids": ctx.state.centroids[0].numpy()})


class StopAfter(mw.Middleware):
    def __init__(self, windows):
        self.windows = windows

    def should_stop(self, ctx):
        return ctx.step >= self.windows


def cpu_mesh(shape, axes):
    return topo.make_mesh(shape, axes, "cpu")


def assert_close_c(got, want):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=CTOL, atol=CTOL)


def assert_same_trace(infos, want, workers=None):
    """The port's worker-major trace against the reference's: equal
    accepts and Lloyd iterations, f_new within RTOL.  ``workers`` picks
    the port's workers that the reference's trace holds."""
    per = len(want["f_new"]) // (len(workers) if workers else 1)
    idx = (np.concatenate([np.arange(w * per, (w + 1) * per)
                           for w in workers]) if workers
           else np.arange(len(want["f_new"])))
    np.testing.assert_array_equal(infos.accepted.numpy()[idx],
                                  want["accepted"])
    np.testing.assert_array_equal(infos.lloyd_iters.numpy()[idx],
                                  want["lloyd_iters"])
    np.testing.assert_allclose(infos.f_new.numpy()[idx], want["f_new"],
                               rtol=RTOL)


def assert_same_windows(got, want):
    """Window by window: the same accepts per worker, and every worker
    holds the same incumbent after the exchange (the winner's)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["n_accepted"] == w["n_accepted"]
        assert len(set(g["f_best"])) == 1
        np.testing.assert_allclose(g["f_best"], w["f_best"], rtol=RTOL)
        assert_close_c(g["centroids"], w["centroids"])


# ---------------------------------------------------------------------------
# big_means_sharded / worker_sharded_rounds against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,axes,cpw", [
    ("data", ("data",), CPW), ("all", ("data", "model"), 4)],
    ids=["data", "data-model"])
def test_sharded_windows_match_reference(ref, name, axes, cpw):
    """On the (4, 2) mesh: four workers over ``("data",)`` (the model axis
    replicates them), eight over ``("data", "model")``.  The reference's
    trace keeps only the workers at model index 0 for the two-axis worker
    mesh (its ``out_specs`` shard the trace over ``axes[0]`` alone); the
    port's keeps every worker, worker-major."""
    want = ref[name]
    rec = Record()
    st, infos, ctx = incore.worker_sharded_rounds(
        ref["X"], REPLAY.key(0), mesh=cpu_mesh((4, 2), ("data", "model")),
        k=K, s=S_, chunks_per_worker=cpw, sync_every=SYNC, axes=axes,
        impl="ref", middlewares=[rec], rng=REPLAY)
    W = 4 if name == "data" else 8
    assert ctx.step == cpw // SYNC and infos.f_new.shape == (W * cpw,)
    assert_same_windows(rec.windows, want["windows"])
    assert_same_trace(infos, want, None if W == 4 else [0, 2, 4, 6])
    assert int(st.n_accepted) == want["n_accepted"]
    np.testing.assert_allclose(float(st.f_best), want["f_best"], rtol=RTOL)
    np.testing.assert_allclose(float(st.n_dist_evals),
                               want["n_dist_evals"], rtol=RTOL)
    assert_close_c(st.centroids, want["centroids"])
    # the one-shot run is the windows run without middleware, bitwise
    st1, inf1 = big_means_sharded(
        ref["X"], REPLAY.key(0), mesh=cpu_mesh((4, 2), ("data", "model")),
        k=K, s=S_, chunks_per_worker=cpw, sync_every=SYNC, axes=axes,
        impl="ref", rng=REPLAY)
    assert torch.equal(st1.centroids, st.centroids)
    assert torch.equal(inf1.f_new, infos.f_new)
    assert float(st1.n_dist_evals) == float(st.n_dist_evals)


def test_sharded_quality_matches_sequential(ref):
    """The reference's own bound (``tests/test_distributed.py:69-71``): the
    sharded fits' full-data objective within 1.15x the sequential fit's at
    the same chunk budget (the port's default key tree)."""
    X = torch.from_numpy(ref["X"])
    mesh = cpu_mesh((4, 2), ("data", "model"))
    st_seq, _ = big_means(X, 0, k=K, s=S_, n_chunks=24, impl="ref",
                          device="cpu")
    f_seq = float(full_objective(X, st_seq.centroids))
    for axes, cpw, sync in ((("data",), CPW, SYNC),
                            (("data", "model"), 4, 4)):
        st, infos = big_means_sharded(X, 0, mesh=mesh, k=K, s=S_,
                                      chunks_per_worker=cpw,
                                      sync_every=sync, axes=axes,
                                      impl="ref")
        assert float(full_objective(X, st.centroids)) <= f_seq * 1.15
        assert int(st.n_accepted) >= 1


# ---------------------------------------------------------------------------
# fit(method="sharded"): checkpoints, the time budget, the auto rule
# ---------------------------------------------------------------------------


def sharded_cfg(**kw):
    return BigMeansConfig(k=K, s=S_, n_chunks=24, sync_every=SYNC,
                          impl="ref", topology=TopologySpec(
                              kind="worker_mesh", devices=4), **kw)


def assert_fit_matches(got, want):
    assert got.strategy == "sharded"
    assert got.n_chunks == want["n_chunks"]
    assert got.n_accepted == want["n_accepted"]
    assert got.n_iterations == want["n_iterations"]
    assert [t[2] for t in got.trace] == [t[2] for t in want["trace"]]
    np.testing.assert_allclose([t[1] for t in got.trace],
                               [t[1] for t in want["trace"]], rtol=RTOL)
    np.testing.assert_allclose(got.objective, want["objective"], rtol=RTOL)
    assert_close_c(got.centroids, want["centroids"])
    for k, v in want["extras"].items():
        assert got.extras[k] == v, k


def test_sharded_fit_matches_reference(ref):
    got = fit(ref["X"], sharded_cfg(), method="sharded", device="cpu",
              rng=REPLAY)
    assert_fit_matches(got, ref["fit"])


def test_sharded_fit_resumes_bitwise(ref, tmp_path):
    """A sharded run stopped after its first window and resumed through
    ``fit(ckpt_dir=...)`` is bitwise the uninterrupted fit: the checkpoint
    (``step_from="step"``) holds the window index, the key and the
    per-worker state stack, and the resumed fit runs windows 1-2 only."""
    X, d = ref["X"], str(tmp_path)
    whole = fit(X, sharded_cfg(), method="sharded", device="cpu",
                rng=REPLAY)
    _, infos, ctx = incore.worker_sharded_rounds(
        X, REPLAY.key(0), mesh=cpu_mesh((4,), ("data",)), k=K, s=S_,
        chunks_per_worker=CPW, sync_every=SYNC, impl="ref", rng=REPLAY,
        middlewares=[mw.Checkpoint(d, SYNC, SYNC, step_from="step"),
                     StopAfter(1)])
    assert ctx.step == 1 and infos.f_new.shape == (4 * SYNC,)
    assert ckpt_lib.latest_step(d) == 1
    resumed = fit(X, sharded_cfg(ckpt_dir=d, ckpt_every=SYNC),
                  method="sharded", device="cpu", rng=REPLAY)
    assert resumed.extras["rounds_done"] == CPW // SYNC
    assert resumed.checkpoint_dir == d
    assert len(resumed.extras["checkpoint"]["restore_ms"]) == 1
    assert torch.equal(resumed.centroids, whole.centroids)
    assert resumed.objective == whole.objective
    # the resumed trace holds windows 1-2 of each worker, as they ran in
    # the uninterrupted fit
    per = CPW
    tail = [t for w in range(4)
            for t in whole.trace[w * per + SYNC:(w + 1) * per]]
    assert [t[1:] for t in resumed.trace] == [t[1:] for t in tail]
    assert ckpt_lib.latest_step(d) == CPW // SYNC
    assert_fit_matches(whole, ref["fit"])


def test_sharded_time_budget_matches_reference(ref):
    """``time_budget_s`` stops the sharded run after its first window, as
    the reference's does, with the same decisions."""
    got = fit(ref["X"], sharded_cfg(time_budget_s=1e-9), method="sharded",
              device="cpu", rng=REPLAY)
    assert got.extras["rounds_done"] == 1
    assert_fit_matches(got, ref["budget"])


def test_sharded_checkpoint_resume_bitwise(tmp_path):
    """The reference's ``tests/test_engine.py::
    test_sharded_checkpoint_resume_bitwise`` on the port: one worker,
    checkpoints every window by window index (``step_from="step"``),
    stopped after window 2 and resumed, bitwise the one-shot run."""
    X = np.random.default_rng(4).normal(size=(4000, 6)).astype(np.float32)
    kwargs = dict(mesh=cpu_mesh((1,), ("data",)), k=5, s=500,
                  chunks_per_worker=8, sync_every=2, impl="ref")
    st_ref, _ = big_means_sharded(X, 7, **kwargs)
    d = str(tmp_path)
    _, _, ctx_a = incore.worker_sharded_rounds(
        X, 7, middlewares=[mw.Checkpoint(d, 1, 2, step_from="step"),
                           StopAfter(2)], **kwargs)
    assert ctx_a.step == 2                      # interrupted mid-run
    assert ckpt_lib.latest_step(d) == 2         # window index, not chunks
    st_b, inf_b, ctx_b = incore.worker_sharded_rounds(
        X, 7, middlewares=[mw.Checkpoint(d, 1, 2, step_from="step")],
        **kwargs)
    assert ctx_b.start_step == 2 and ctx_b.step == 4
    assert inf_b.f_new.numel() == 4             # windows 2-3 only
    assert torch.equal(st_b.centroids, st_ref.centroids)
    assert float(st_b.f_best) == float(st_ref.f_best)
    with pytest.raises(ValueError, match="step_from"):
        mw.Checkpoint(d, 1, 2, step_from="windows")


def test_auto_derives_compatible_sync_every(monkeypatch):
    """A run that sees 4 devices goes to ``sharded``; with 2 chunks a
    worker, ``sync_every=3`` becomes the largest divisor <= 3 (reference
    ``tests/test_engine.py::test_auto_derives_compatible_sync_every``).
    The adjusted fit is bitwise the explicit one."""
    X = np.random.default_rng(5).normal(size=(4000, 6)).astype(np.float32)
    monkeypatch.setattr(topo, "_local_device_count", lambda device=None: 4)
    cfg = BigMeansConfig(k=5, s=600, n_chunks=8, sync_every=3, impl="ref")
    cpu = torch.device("cpu")
    assert S.resolve_auto(cfg, as_source(X), cpu) == "sharded"
    assert S.resolve_auto(cfg.replace(n_chunks=6), as_source(X),
                          cpu) == "sequential"      # 4 does not divide 6
    r = fit(X, cfg, device="cpu")
    assert r.strategy == "sharded" and r.extras["auto"]
    assert r.extras["workers"] == 4
    assert r.extras["sync_every_adjusted"] == {"requested": 3, "used": 2}
    want = fit(X, cfg.replace(sync_every=2), method="sharded", device="cpu")
    assert torch.equal(r.centroids, want.centroids)
    assert r.trace == want.trace
    # a worker mesh with checkpoints on in-core data also goes to sharded
    wm = cfg.replace(sync_every=2, ckpt_dir="unused",
                     topology=TopologySpec(kind="worker_mesh", devices=4))
    assert S.resolve_auto(wm, as_source(X), cpu) == "sharded"
    monkeypatch.setattr(topo, "_local_device_count", lambda device=None: 1)
    assert S.resolve_auto(cfg, as_source(X), cpu) == "sequential"


@pytest.mark.parametrize("cfg,error", [
    (dict(n_chunks=10), "divide n_chunks"),
    (dict(sync_every=4), "divide chunks_per_worker"),
], ids=["workers", "sync_every"])
def test_sharded_validates_composition(cfg, error):
    X = np.zeros((400, 3), np.float32)
    c = BigMeansConfig(k=2, s=50, n_chunks=8, impl="ref",
                       topology=TopologySpec(kind="worker_mesh", devices=4))
    with pytest.raises(ValueError, match=error):
        fit(X, c.replace(**cfg), method="sharded", device="cpu")


def test_sharded_core_validates_shapes():
    """Rows not divisible by the workers, and a ``sync_every`` that does
    not divide the chunks a worker, raise (the reference's shard_map and
    assert); the sharded strategy needs in-core data."""
    mesh = cpu_mesh((3,), ("data",))
    X = np.zeros((400, 3), np.float32)
    with pytest.raises(ValueError, match="rows"):
        big_means_sharded(X, 0, mesh=mesh, k=2, s=50, chunks_per_worker=2,
                          impl="ref")
    with pytest.raises(ValueError, match="sync_every"):
        big_means_sharded(X[:399], 0, mesh=mesh, k=2, s=50,
                          chunks_per_worker=3, sync_every=2, impl="ref")
    with pytest.raises(ValueError, match="'bogus'"):
        big_means_sharded(X, 0, mesh=mesh, k=2, s=50, chunks_per_worker=2,
                          axes=("bogus",), impl="ref")
    with pytest.raises(TypeError, match="in-core"):
        fit(lambda cid: X[:50], BigMeansConfig(k=2, s=50, n_chunks=2),
            method="sharded", device="cpu", n_features=3)


def test_legacy_mesh_axes_knob():
    """``mesh_axes`` without a mesh names the worker axis (the reference's
    legacy knob): one worker on the CPU, the same fit."""
    X = np.random.default_rng(6).normal(size=(2000, 4)).astype(np.float32)
    cfg = BigMeansConfig(k=3, s=200, n_chunks=4, impl="ref")
    a = fit(X, cfg.replace(mesh_axes=("rows",)), method="sharded",
            device="cpu")
    b = fit(X, cfg, method="sharded", device="cpu")
    assert a.extras["workers"] == b.extras["workers"] == 1
    assert torch.equal(a.centroids, b.centroids)


# ---------------------------------------------------------------------------
# the stream mesh
# ---------------------------------------------------------------------------


def test_stream_mesh_bitwise_batched_local(ref):
    """``batch=8`` over 4 stream groups is bitwise the port's
    ``batched_local`` (its trace group-major: each group's round-major
    trace in turn), and takes the reference's stream-mesh decisions in
    the reference's trace order."""
    X = ref["X"]
    kw = dict(k=K, s=S_, batch=8, rounds=4, sync_every=2, impl="ref",
              rng=REPLAY)
    st_l, inf_l = big_means_batched(X, REPLAY.key(0), device="cpu", **kw)
    st_m, inf_m = big_means_batched(
        X, REPLAY.key(0), mesh=cpu_mesh((4,), ("streams",)), **kw)
    assert torch.equal(st_l.centroids, st_m.centroids)
    assert torch.equal(st_l.f_best, st_m.f_best)
    assert int(st_l.n_accepted) == int(st_m.n_accepted)
    np.testing.assert_allclose(float(st_m.n_dist_evals),
                               float(st_l.n_dist_evals), rtol=RTOL)

    def group_major(a):                         # [rounds, groups, 2]
        return a.view(4, 4, 2).permute(1, 0, 2).reshape(-1)

    for f in ("f_new", "accepted", "lloyd_iters"):
        assert torch.equal(group_major(getattr(inf_l, f)),
                           getattr(inf_m, f)), f
    for name, infos, st in (("local", inf_l, st_l),
                            ("stream_mesh", inf_m, st_m)):
        assert_same_trace(infos, ref[name])
        assert int(st.n_accepted) == ref[name]["n_accepted"]
        np.testing.assert_allclose(float(st.f_best), ref[name]["f_best"],
                                   rtol=RTOL)
        assert_close_c(st.centroids, ref[name]["centroids"])


def test_stream_mesh_fit_and_shim():
    """``fit(batch=8, topology=stream_mesh)`` and the deprecated raw mesh
    run the stream mesh; a mesh whose groups do not divide the batch is
    refused."""
    import warnings

    X = np.random.default_rng(7).normal(size=(2000, 5)).astype(np.float32)
    cfg = BigMeansConfig(k=4, s=200, n_chunks=8, batch=4, sync_every=2,
                         impl="ref")
    plain = fit(X, cfg, device="cpu")
    spec = fit(X, cfg.replace(topology=TopologySpec(
        kind="stream_mesh", devices=2)), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        leg_cfg = cfg.replace(mesh=cpu_mesh((2,), ("streams",)))
    leg = fit(X, leg_cfg, device="cpu")
    for r in (spec, leg):
        assert r.strategy == "batched"
        assert torch.equal(r.centroids, plain.centroids)
        assert r.objective == plain.objective
    assert spec.trace == leg.trace
    with pytest.raises(ValueError, match="divide batch"):
        fit(X, cfg.replace(topology=TopologySpec(kind="stream_mesh",
                                                 devices=3)), device="cpu")


def test_batched_rejects_worker_topology():
    X = np.zeros((400, 3), np.float32)
    cfg = BigMeansConfig(k=2, s=50, n_chunks=8, batch=2, impl="ref",
                         topology=TopologySpec(kind="worker_mesh",
                                               devices=4))
    with pytest.raises(ValueError, match="batched"):
        fit(X, cfg, method="batched", device="cpu")
    with pytest.raises(ValueError, match="stream axis"):
        fit(X, cfg, method="streaming", device="cpu")


@pytest.mark.parametrize("sync_every", [1, 2], ids=["fold", "persistent"])
def test_streaming_stream_mesh_bitwise_single_device(sync_every):
    """The stream loop over a 4-group stream mesh is bitwise the
    one-device loop, in fold and persistent mode (the reference's
    ``tests/test_engine.py::test_streaming_mesh_matches_single_device``
    holds it within fp tolerance)."""
    def provider(cid):
        return np.random.default_rng((3, cid)).normal(
            size=(256, 6)).astype(np.float32)

    cfg = BigMeansConfig(k=5, s=256, n_chunks=8, batch=4, seed=1,
                         sync_every=sync_every, impl="ref", log_every=1)
    mesh = stream.run_stream(
        provider, cfg, n_features=6, device="cpu",
        topology=topo.StreamMesh(cpu_mesh((4,), ("streams",))))
    one = stream.run_stream(provider, cfg, n_features=6, device="cpu")
    assert torch.equal(mesh[0].centroids, one[0].centroids)
    assert torch.equal(mesh[0].f_best, one[0].f_best)
    assert mesh[1].trace == one[1].trace
    assert mesh[1].accepted == one[1].accepted


def test_api_exports_topology():
    assert api.TopologySpec is TopologySpec
    assert api.DeviceMesh is topo.DeviceMesh
    assert "sharded" in api.list_methods()
