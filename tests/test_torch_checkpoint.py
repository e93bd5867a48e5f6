"""Checkpoints in the port: ``repro_torch.cluster.checkpoint``, the
``Checkpoint`` middleware and resumed streaming runs, against the
reference's ``repro.cluster.checkpoint`` and ``repro.engine.stream``.

The two packages share one on-disk layout (``step_%012d/arrays.npz`` with
leaves ``a0 … aN`` in ``jax.tree.flatten``'s order, and ``meta.json``), so
each reads the other's files: the leaf order is held to
``jax.tree.flatten`` on the reference's own trees, a port checkpoint
restores in the reference (``repro.serve.swap.load_centroids`` included)
and a reference checkpoint in the port.  Under the jax-replay key tree a
run checkpointed by one package and resumed by the other takes the
decisions of the reference's own runs: the same accepts, chunk ids and
trace events, floats within ``RTOL`` (summation order).  The rest mirrors
the checkpoint tests of ``tests/test_runtime.py``, ``tests/test_faults.py``
and ``tests/test_engine.py`` on the port, on the CPU.
"""
import collections
import json
import os
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.cluster import checkpoint as jcheckpoint
from repro.core import bigmeans as jbigmeans
from repro.engine import middleware as jmw
from repro.engine import stream as jstream
from repro.serve import swap as jswap
from repro_torch import api
from repro_torch import random as rnd
from repro_torch.cluster import checkpoint, runner
from repro_torch.core import bigmeans
from repro_torch.data.synthetic import GMMSpec, gmm_chunk
from repro_torch.engine import faults
from repro_torch.engine import middleware as mw
from repro_torch.engine import stream
from test_torch_rng import REPLAY
from test_torch_stream import RTOL, assert_same_trace, mixture_provider

SPEC = GMMSpec(m=10**5, n=8, components=5, seed=3)


def provider(cid):
    return gmm_chunk(SPEC, cid, 512, device="cpu").numpy()


def cfg_for(**kw):
    base = dict(k=5, s=512, n_chunks=8, prefetch=0, seed=1)
    base.update(kw)
    return api.BigMeansConfig(**base)


def run(prov, cfg, **kw):
    return runner.run(prov, cfg, n_features=8, device="cpu", **kw)


def progress(trace, first=0):
    """The ``(chunk_id, f_best, f_new)`` entries from chunk ``first`` on."""
    return [t for t in trace if not isinstance(t[0], str) and t[0] >= first]


# ---------------------------------------------------------------------------
# the library (tests/test_runtime.py, tests/test_faults.py)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_keep(tmp_path):
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3))}}
    for step in (1, 2, 3, 4, 5):
        checkpoint.save(str(tmp_path), step, tree, keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    restored, step = checkpoint.restore(str(tmp_path), tree)
    assert step == 5
    assert torch.equal(restored["a"], torch.arange(5.0))
    assert torch.equal(restored["b"]["c"], torch.ones((2, 3)))
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(kept) == 2                   # keep-last-N enforced


def test_checkpoint_elastic_resharding(tmp_path):
    """Restore onto a named device: arrays are stored as full logical
    values, so any target works; non-tensor leaves stay numpy."""
    tree = {"c": torch.ones((8, 4)), "k": np.arange(2, dtype=np.uint32)}
    checkpoint.save(str(tmp_path), 1, tree)
    restored, _ = checkpoint.restore(str(tmp_path), tree, device="cpu")
    assert restored["c"].device == torch.device("cpu")
    assert torch.equal(restored["c"], tree["c"])
    assert isinstance(restored["k"], np.ndarray)
    assert restored["k"].dtype == np.uint32


def ckpt_tree():
    return (np.arange(12, dtype=np.float32).reshape(3, 4),
            np.float32(7.0))


def test_checkpoint_save_writes_digests(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 5, ckpt_tree())
    meta = json.loads(
        (tmp_path / "step_000000000005" / "meta.json").read_text())
    assert sorted(meta) == ["digests", "n_leaves", "step", "treedef"]
    assert "arrays.npz" in meta["digests"]
    assert checkpoint.verify_step(d, 5)
    assert checkpoint.latest_intact_step(d) == 5


def test_truncated_checkpoint_falls_back_to_previous(tmp_path):
    d = str(tmp_path)
    tree = ckpt_tree()
    checkpoint.save(d, 5, (tree[0], np.float32(5.0)))
    checkpoint.save(d, 9, (tree[0], np.float32(9.0)))
    faults.corrupt_checkpoint(d)             # mangles newest (step 9)

    assert checkpoint.latest_step(d) == 9    # still listed...
    assert not checkpoint.verify_step(d, 9)  # ...but detected corrupt
    assert checkpoint.latest_intact_step(d) == 5
    restored, step = checkpoint.restore(d, tree)
    assert float(restored[1]) == 5.0 and step == 5  # fell back


def test_restore_all_corrupt_raises_not_garbage(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 3, ckpt_tree())
    faults.corrupt_checkpoint(d, step=3)
    with pytest.raises(FileNotFoundError, match="no intact checkpoint"):
        checkpoint.restore(d, ckpt_tree())


def test_save_cleans_stale_tmp_dirs(tmp_path):
    stale = tmp_path / "tmp.000000000001"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"torn write")
    checkpoint.save(str(tmp_path), 2, ckpt_tree())
    assert not stale.exists()
    assert checkpoint.steps(str(tmp_path)) == [2]


Pair = collections.namedtuple("Pair", ["zeta", "alpha"])


def _trees():
    """(name, numpy spec) of trees whose leaf order must be jax's: the
    reference test's dict, the engine payload, and nesting of every kind
    (dict keys inserted out of order, a NamedTuple whose fields are not
    sorted, lists, ``None``)."""
    a = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    state = (a, np.zeros(4, bool), np.float32(2.5), np.int32(3),
             np.float32(9.0))
    return [
        ("runtime_dict", {"a": np.arange(5.0), "b": {"c": np.ones((2, 3))}}),
        ("engine_payload", ((state, np.asarray([0, 7], np.uint32)),
                            np.asarray([1, 2, 512], np.int64))),
        ("nested", {"z": [np.int64(1), None, (np.float32(2.0),)],
                    "b": Pair(zeta=np.ones(2), alpha={"y": np.zeros(1),
                                                     "x": np.arange(3)}),
                    "m": None}),
    ]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _as(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, Pair):
        return Pair(*(_as(c, fn) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as(c, fn) for c in tree)
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("name,spec", _trees(), ids=[t[0] for t in _trees()])
def test_leaf_order_is_jax_tree_flatten(name, spec, tmp_path):
    """The port's flatten gives jax's leaves in jax's order on the same
    tree, and a save by either package restores in the other."""
    # tensors in the port's tree, the key leaf kept numpy as the engine
    # keeps it; the reference's own tree holds the numpy leaves
    port_tree = _as(spec, lambda x: x if x.dtype == np.uint32
                    else torch.from_numpy(np.array(x)))
    want = jax.tree.flatten(spec)[0]
    got = checkpoint.flatten(port_tree)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _np(g).dtype == w.dtype
        np.testing.assert_array_equal(_np(g), w)
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    checkpoint.save(d_port, 1, port_tree)
    jcheckpoint.save(d_ref, 1, spec)
    from_port, _ = jcheckpoint.restore(d_port, spec)
    from_ref, _ = checkpoint.restore(d_ref, port_tree)
    for a, b in zip(jax.tree.leaves(from_port), want):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(checkpoint.flatten(from_ref)[0], got):
        assert type(a) is type(b) and _np(a).dtype == _np(b).dtype
        np.testing.assert_array_equal(_np(a), _np(b))
    assert type(from_ref) is type(port_tree)


def test_unflatten_keeps_the_structure():
    spec = _trees()[2][1]
    leaves, structure = checkpoint.flatten(spec)
    back = checkpoint.unflatten(spec, leaves)
    assert list(back) == list(spec) and back["m"] is None
    assert isinstance(back["b"], Pair) and back["b"].alpha["x"] is \
        spec["b"].alpha["x"]
    assert structure == ("{'b': Pair(*, {'x': *, 'y': *}), 'm': None, "
                         "'z': [*, None, (*)]}")


def test_engine_payload_dtypes(tmp_path):
    """The engine payload's seven leaves keep the reference's dtypes: the
    0-d ``f_best`` f32 and ``n_accepted`` i32, the key u32[2], the aux
    i64[3]."""
    cfg = cfg_for(n_chunks=3, ckpt_dir=str(tmp_path), ckpt_every=2)
    run(provider, cfg)
    step = checkpoint.latest_step(str(tmp_path))
    with np.load(tmp_path / f"step_{step:012d}" / "arrays.npz") as z:
        got = [(f, z[f].dtype.str, z[f].shape) for f in z.files]
    assert got == [("a0", "<f4", (5, 8)), ("a1", "|b1", (5,)),
                   ("a2", "<f4", ()), ("a3", "<i4", ()), ("a4", "<f4", ()),
                   ("a5", "<u4", (2,)), ("a6", "<i8", (3,))]


# ---------------------------------------------------------------------------
# both ways across packages
# ---------------------------------------------------------------------------


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    d = str(tmp_path)
    cfg = cfg_for(n_chunks=6, ckpt_dir=d, ckpt_every=4)
    state, _ = stream.run_stream(provider, cfg, n_features=8, device="cpu",
                                 rng=REPLAY)
    assert jcheckpoint.steps(d) == checkpoint.steps(d) == [4, 6]
    for step in (4, 6):
        assert jcheckpoint.verify_step(d, step)
    example = ((jbigmeans.init_state(5, 8), jax.random.PRNGKey(0)),
               np.zeros(3, np.int64))
    ((jstate, key), aux), step = jcheckpoint.restore(d, example)
    assert step == 6
    np.testing.assert_array_equal(np.asarray(jstate.centroids),
                                  state.centroids.numpy())
    assert np.asarray(jstate.f_best) == state.f_best.numpy()
    np.testing.assert_array_equal(np.asarray(key), jax.random.PRNGKey(1))
    assert jmw.load_loop_state(d) == mw.load_loop_state(d) == {
        "rung": 0, "stall": 0, "last_s": 512}
    centroids, got = jswap.load_centroids(d)
    assert got == 6
    np.testing.assert_array_equal(centroids, state.centroids.numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    d = str(tmp_path)
    jcfg = japi.BigMeansConfig(k=5, s=512, n_chunks=6, prefetch=0, seed=1,
                               impl="ref", ckpt_dir=d, ckpt_every=4)
    jstate, _ = jstream.run_stream(provider, jcfg, n_features=8)
    example = ((bigmeans.init_state(5, 8, device="cpu"),
                np.zeros(2, np.uint32)), np.zeros(3, np.int64))
    ((state, key), aux), step = checkpoint.restore(d, example)
    assert step == 6 and checkpoint.steps(d) == [4, 6]
    for got, want in zip(state, jstate):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(1)))
    assert mw.load_loop_state(d) == jmw.load_loop_state(d)
    # and the middleware restores it into a run's context
    ctx = mw.EngineContext(cfg=None, key=REPLAY.key(1),
                           metrics=stream.RunnerMetrics(), rng=REPLAY)
    ck = mw.Checkpoint(d, every=4, batch=1)
    assert ck.maybe_restore(ctx, bigmeans.init_state(5, 8, device="cpu"))
    assert ctx.start_step == ctx.step == 6 and ctx.last_s == 512
    np.testing.assert_array_equal(np.asarray(ctx.key),
                                  np.asarray(jax.random.PRNGKey(1)))


def _ref_run(prov, kw, d, **extra):
    return jstream.run_stream(prov, japi.BigMeansConfig(
        impl="ref", ckpt_dir=d, **kw), n_features=8, **extra)


def _port_run(prov, kw, d, **extra):
    return stream.run_stream(prov, api.BigMeansConfig(ckpt_dir=d, **kw),
                             n_features=8, rng=REPLAY, device="cpu", **extra)


def _same_metrics(m, jm):
    for f in ("chunks_done", "chunks_failed", "chunks_dropped",
              "chunks_quarantined", "accepted", "lloyd_iters"):
        assert getattr(m, f) == getattr(jm, f), f
    np.testing.assert_allclose(m.f_best, jm.f_best, rtol=RTOL)
    assert_same_trace(m.trace, jm.trace)


def _bomb(cid):
    if cid in (5, 11):
        raise RuntimeError("node lost")


RESUME_MODES = {"fold-b1": dict(), "fold-b4": dict(batch=4, sync_every=1),
                "persistent-b4": dict(batch=4, sync_every=2),
                "fold-b1-failed": dict()}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("mode", list(RESUME_MODES))
def test_cross_package_resume_under_replay(writer, mode, tmp_path):
    """One package checkpoints 8 chunks, both resume to 16 from copies of
    that directory: the same decisions, traces and steps.  In fold mode the
    resumed run also takes the reference's uninterrupted decisions."""
    prov = mixture_provider()
    kw = dict(k=5, s=512, seed=2, prefetch=0, log_every=1, ckpt_every=3,
              **RESUME_MODES[mode])
    extra = {"fault_injector": _bomb} if mode.endswith("failed") else {}
    first = _ref_run if writer == "reference" else _port_run
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    _, m8 = first(prov, dict(kw, n_chunks=8, resume=False), d_ref, **extra)
    shutil.copytree(d_ref, d_port)
    jstate, jm = _ref_run(prov, dict(kw, n_chunks=16), d_ref, **extra)
    state, m = _port_run(prov, dict(kw, n_chunks=16), d_port, **extra)
    _same_metrics(m, jm)
    np.testing.assert_allclose(state.centroids.numpy(),
                               np.asarray(jstate.centroids), rtol=RTOL,
                               atol=RTOL * 20)
    assert checkpoint.steps(d_port) == jcheckpoint.steps(d_ref)
    assert mw.load_loop_state(d_port) == jmw.load_loop_state(d_ref)
    if mode in ("fold-b1", "fold-b4"):
        d_full = str(tmp_path / "full")
        _, jfull = _ref_run(prov, dict(kw, n_chunks=16), d_full)
        assert m8.chunks_done + m.chunks_done == jfull.chunks_done
        assert m8.accepted + m.accepted == jfull.accepted
        assert_same_trace(progress(m.trace, 8), progress(jfull.trace, 8))
        np.testing.assert_allclose(m.f_best, jfull.f_best, rtol=RTOL)
        assert checkpoint.steps(d_port) == jcheckpoint.steps(d_full)
    if mode == "fold-b1-failed":    # the final step lagged: id 7 redone
        assert m8.chunks_done == 7 and m.chunks_done + m.chunks_failed == 9


@pytest.mark.parametrize("mode", ["fold-b1", "fold-b4"])
def test_resume_is_bitwise_uninterrupted(mode, tmp_path):
    """In fold mode a split run of the port (its own key tree) is bitwise
    the uninterrupted one: state, trace of the second half, steps and the
    newest checkpoint's leaves."""
    prov = mixture_provider()
    cfg = api.BigMeansConfig(k=5, s=512, seed=4, prefetch=2, log_every=1,
                             ckpt_every=3, n_chunks=16, **RESUME_MODES[mode])
    d_full, d_split = str(tmp_path / "full"), str(tmp_path / "split")
    full, m_full = run(prov, cfg.replace(ckpt_dir=d_full))
    _, m8 = run(prov, cfg.replace(ckpt_dir=d_split, n_chunks=8,
                                  resume=False))
    res, m = run(prov, cfg.replace(ckpt_dir=d_split))
    assert m.chunks_done == 8 and m8.accepted + m.accepted == m_full.accepted
    for got, want in zip(res, full):
        assert torch.equal(got, want)
    assert m.trace == progress(m_full.trace, 8)
    assert checkpoint.steps(d_split) == checkpoint.steps(d_full)
    step = checkpoint.latest_step(d_full)
    for d in (d_split, d_full):
        assert checkpoint.verify_step(d, step)
    example = ((full, np.zeros(2, np.uint32)), np.zeros(3, np.int64))
    a, _ = checkpoint.restore(d_split, example)
    b, _ = checkpoint.restore(d_full, example)
    for x, y in zip(checkpoint.flatten(a)[0], checkpoint.flatten(b)[0]):
        assert np.array_equal(_np(x), _np(y))


def test_budgeted_run_resumes_as_the_reference(tmp_path, monkeypatch):
    """A time budget stops the run after the checkpoint's window hook;
    ``on_finish`` saves at ``start_step + chunks_done`` and the resumed
    run continues from there, in both packages alike (a scripted clock:
    one second a fetch)."""
    now = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    base = mixture_provider()

    def prov(cid):
        now[0] += 1.0
        return base(cid)

    kw = dict(k=5, s=512, n_chunks=12, prefetch=0, seed=1, log_every=1,
              batch=3, ckpt_every=2)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    runs = []
    for budget in (4.5, None):
        now[0] = 0.0
        _, jm = _ref_run(prov, dict(kw, time_budget_s=budget), d_ref)
        now[0] = 0.0
        _, m = _port_run(prov, dict(kw, time_budget_s=budget), d_port)
        _same_metrics(m, jm)
        assert checkpoint.steps(d_port) == jcheckpoint.steps(d_ref)
        runs.append(m)
    stopped, resumed = runs
    assert stopped.chunks_dropped > 0
    assert stopped.chunks_done + resumed.chunks_done == 12


def test_steps_lists_equal_with_a_failed_chunk(tmp_path):
    """Uninterrupted runs with failed fetches: the final step lags behind
    the stream (``start_step + chunks_done``) in both packages alike."""
    prov = mixture_provider()
    kw = dict(k=5, s=512, seed=2, prefetch=0, n_chunks=13, ckpt_every=4)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    _, jm = _ref_run(prov, kw, d_ref, fault_injector=_bomb)
    _, m = _port_run(prov, kw, d_port, fault_injector=_bomb)
    _same_metrics(m, jm)
    assert checkpoint.steps(d_port) == jcheckpoint.steps(d_ref) == [4, 8, 11]


# ---------------------------------------------------------------------------
# resumes (tests/test_engine.py, tests/test_faults.py, tests/test_runtime.py)
# ---------------------------------------------------------------------------


def test_streaming_resume_preserves_vns_state(tmp_path):
    fixed = provider(0)
    prov = lambda cid: fixed               # identical chunks: acceptance stalls
    base = dict(k=5, s=512, vns_ladder=(256, 128), vns_patience=3, seed=7,
                prefetch=0, log_every=0, ckpt_every=100)
    d_full, d_res = str(tmp_path / "full"), str(tmp_path / "res")
    st_full, _ = run(prov, api.BigMeansConfig(n_chunks=14, ckpt_dir=d_full,
                                              **base))
    aux_full = mw.load_loop_state(d_full)
    run(prov, api.BigMeansConfig(n_chunks=7, ckpt_dir=d_res, **base))
    aux_mid = mw.load_loop_state(d_res)
    assert aux_mid is not None and aux_mid["rung"] > 0  # ladder persisted
    st_res, m = run(prov, api.BigMeansConfig(n_chunks=14, ckpt_dir=d_res,
                                             **base))
    assert m.chunks_done == 7
    # interrupted + resumed == uninterrupted, ladder state included
    assert torch.equal(st_full.centroids, st_res.centroids)
    assert float(st_full.f_best) == float(st_res.f_best)
    assert mw.load_loop_state(d_res) == aux_full


def test_streaming_resume_accepts_legacy_checkpoints(tmp_path):
    """A legacy ``(state, key)`` checkpoint (six leaves) restores with the
    ladder state reset, not a crash."""
    d = str(tmp_path)
    cfg = cfg_for(s=512, n_chunks=6, ckpt_dir=d)
    state = bigmeans.init_state(5, 8, device="cpu")
    checkpoint.save(d, 3, (state, rnd.TORCH.key_to_array(rnd.TORCH.key(1))))
    assert checkpoint.n_leaves(d) == 6
    st, m = run(provider, cfg)
    assert m.chunks_done == 3                   # resumed from chunk 3
    assert np.isfinite(m.f_best)


def test_runner_restart_resumes_not_restarts(tmp_path):
    cfg = cfg_for(n_chunks=10, ckpt_dir=str(tmp_path), ckpt_every=5,
                  prefetch=2)
    run(provider, cfg)
    _, m2 = run(provider, cfg.replace(n_chunks=25))
    assert m2.chunks_done == 15                 # resumed past the first 10


def test_runner_resumes_from_intact_step_after_corruption(tmp_path):
    cfg = cfg_for(n_chunks=8, ckpt_dir=str(tmp_path), ckpt_every=3)
    run(provider, cfg)
    assert checkpoint.steps(str(tmp_path)) == [3, 6, 8]
    newest = checkpoint.latest_step(str(tmp_path))
    faults.corrupt_checkpoint(str(tmp_path))
    st, m = run(provider, cfg.replace(n_chunks=10))
    fallbacks = [t for t in m.trace if t[0] == "ckpt_fallback"]
    assert fallbacks == [("ckpt_fallback", 6)] and 6 < newest
    assert m.chunks_done == 4                   # chunks 6..9
    assert np.isfinite(float(st.f_best))


def test_runner_fresh_start_when_every_step_corrupt(tmp_path):
    cfg = cfg_for(n_chunks=4, ckpt_dir=str(tmp_path), ckpt_every=2)
    fresh, _ = run(provider, cfg.replace(ckpt_dir=None))
    run(provider, cfg)
    for s in checkpoint.steps(str(tmp_path)):
        faults.corrupt_checkpoint(str(tmp_path), step=s)
    st, m = run(provider, cfg)
    assert ("ckpt_fallback", None) in m.trace   # restarted from scratch
    assert m.chunks_done == 4                   # full rerun, not resumed
    assert torch.equal(st.centroids, fresh.centroids)
    assert float(st.f_best) == float(fresh.f_best)


def test_chaos_run_with_a_torn_checkpoint_matches_reference(tmp_path):
    """The checkpoint half of ``test_chaos_run_completes_and_reconciles``:
    staged checkpoints, the newest torn, then a seeded fault plan — exact
    accounting, the fallback recorded, the health record and the decisions
    the reference's, the objective within 5 % of the clean fit."""
    kw = dict(k=5, s=512, n_chunks=16, prefetch=2, seed=1, retries=2,
              retry_backoff_s=0.0, fetch_timeout_s=5.0, ckpt_every=5)
    plan_kw = dict(seed=13, transient_rate=0.25, transient_attempts=1,
                   permanent_ids=(12,), nan_ids=(14,))
    out = {}
    for pkg in ("port", "reference"):
        d = str(tmp_path / pkg)
        if pkg == "port":
            cfg = api.BigMeansConfig(ckpt_dir=d, **kw)
            go = lambda prov, c, **x: api.fit(  # noqa: E731
                prov, c, method="streaming", n_features=8, device="cpu",
                rng=REPLAY, **x)
            stage, plan = _port_run, faults.FaultPlan(**plan_kw)
        else:
            from repro.engine import faults as jfaults
            cfg = japi.BigMeansConfig(ckpt_dir=d, impl="ref", **kw)
            go = lambda prov, c, **x: japi.fit(  # noqa: E731
                prov, c, method="streaming", n_features=8, **x)
            stage, plan = _ref_run, jfaults.FaultPlan(**plan_kw)
        clean = go(provider, cfg.replace(ckpt_dir=None))
        stage(provider, dict(kw, n_chunks=11), d)
        faults.corrupt_checkpoint(d)
        result = go(plan.wrap(provider), cfg)
        h = result.health
        assert (h["chunks_done"] + h["chunks_failed"] + h["chunks_dropped"]
                + h["chunks_quarantined"]) == h["chunks_fetched"]
        assert h["chunks_failed"] == 1           # the permanent fault only
        assert h["chunks_quarantined"] == 1      # the NaN chunk
        assert h["ckpt_fallback"] == 10          # healed past the torn write
        assert h["quarantine_reasons"] == [(14,
                                            "non-finite values (NaN/Inf)")]
        assert result.objective <= clean.objective * 1.05
        assert result.checkpoint_dir == d
        out[pkg] = result
    port, ref = out["port"], out["reference"]
    assert port.health == ref.health
    assert port.n_accepted == ref.n_accepted
    assert_same_trace(port.trace, ref.trace)
    np.testing.assert_allclose(port.objective, ref.objective, rtol=RTOL)


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [
    dict(), dict(batch=4), dict(batch=4, sync_every=2),
    dict(vns_ladder=(200,)), dict(time_budget_s=60.0)],
    ids=["plain", "batch4", "persistent", "vns", "budget"])
def test_resolve_auto_with_ckpt_dir_matches_reference(knobs, tmp_path):
    X = np.random.default_rng(0).normal(size=(600, 5)).astype(np.float32)
    kw = dict(k=3, s=300, n_chunks=4, ckpt_dir=str(tmp_path), **knobs)
    for src, jsrc in ((api.ArraySource(X), japi.ArraySource(X)),
                      (api.ProviderSource(provider, n_features=8),
                       japi.ProviderSource(provider, n_features=8))):
        got = api.resolve_auto(api.BigMeansConfig(**kw), src)
        assert got == japi.resolve_auto(japi.BigMeansConfig(**kw), jsrc)
        assert got == "streaming"


def test_hung_restore_blocks_until_release(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, ckpt_tree())
    out = []
    with faults.hung_restore() as release:
        worker = threading.Thread(
            target=lambda: out.append(checkpoint.restore(d, ckpt_tree())))
        worker.start()
        worker.join(timeout=0.3)
        assert worker.is_alive() and not out    # stalled inside restore
        release.set()
        worker.join(timeout=10)
    assert not worker.is_alive() and out[0][1] == 1
    assert checkpoint.restore.__name__ == "restore"     # unpatched on exit


def test_fit_sets_checkpoint_dir_and_times(tmp_path):
    X = np.random.default_rng(0).normal(size=(4000, 5)).astype(np.float32)
    d = str(tmp_path)
    res = api.fit(X, k=3, s=500, n_chunks=6, ckpt_dir=d, ckpt_every=2,
                  device="cpu")
    assert res.strategy == "streaming" and res.extras["auto"]
    assert res.checkpoint_dir == d and checkpoint.steps(d) == [2, 4, 6]
    times = res.extras["checkpoint"]
    assert len(times["save_ms"]) == 3
    assert times["restore_ms"] == []
    again = api.fit(X, k=3, s=500, n_chunks=8, ckpt_dir=d, ckpt_every=2,
                    device="cpu")
    assert again.n_chunks == 2 and len(again.extras["checkpoint"]
                                       ["restore_ms"]) == 1
    assert api.fit(X, k=3, s=500, n_chunks=2, device="cpu"
                   ).checkpoint_dir is None


def test_runner_run_matches_reference_runner(tmp_path):
    """``runner.run``, the reference's historical entry point: under
    ``REPLAY`` it checkpoints, fails and resumes as
    ``repro.cluster.runner.run`` does."""
    from repro.cluster import runner as jrunner
    prov = mixture_provider()
    kw = dict(k=5, s=512, seed=2, prefetch=0, log_every=1, ckpt_every=3)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    for n_chunks in (7, 13):
        jstate, jm = jrunner.run(
            prov, japi.BigMeansConfig(impl="ref", ckpt_dir=d_ref,
                                      n_chunks=n_chunks, **kw),
            n_features=8, fault_injector=_bomb)
        state, m = runner.run(
            prov, api.BigMeansConfig(ckpt_dir=d_port, n_chunks=n_chunks,
                                     **kw),
            n_features=8, fault_injector=_bomb, rng=REPLAY, device="cpu")
        _same_metrics(m, jm)
        np.testing.assert_allclose(state.centroids.numpy(),
                                   np.asarray(jstate.centroids), rtol=RTOL,
                                   atol=RTOL * float(np.abs(
                                       np.asarray(jstate.centroids)).max()))
        assert checkpoint.steps(d_port) == jcheckpoint.steps(d_ref)
    assert m.chunks_done + m.chunks_failed == 13 - 6    # resumed at step 6
