"""Faults and middleware: the port's time budget, VNS ladder, schedulers,
``FaultPlan`` and ``FitResult`` methods against the reference's.

Parity runs hand the same numpy chunks to ``repro.engine.stream.run_stream``
(``impl="ref"``) and the port's ``run_stream`` on the CPU with the
jax-replay key tree, so the port must take every decision the reference
takes: the same VNS rungs and chunk sizes, the same ``competitive_s`` moves,
final sizes and winner, the same stop window under a time budget, the same
health record under injected faults.  Floats differ only by summation order
(``RTOL``).  The ``competitive_s`` data (hepmass-16k) has no near tie
between two streams' eval scores: the closest distinct pair of a window is
0.29 % apart under every policy, against the 1e-7 by which the two
packages' scores differ.

The rest mirrors the non-checkpoint tests of ``tests/test_faults.py`` and
``tests/test_engine.py``'s budget and scheduler tests on the port.
``test_kernel_failure_demotes_once_and_falls_back`` and
``test_kernel_fallback_surfaces_on_fit_result`` are not mirrored: the port
keeps no demotion registry (a kernel that fails raises), which
``test_kernel_failure_swaps_every_policy`` here and a ``cuda`` test in
``test_torch_cuda.py`` pin instead.
"""
import re
import threading
import time

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.engine import faults as jfaults
from repro.engine import middleware as jmw
from repro.engine import scheduler as jsched
from repro.engine import stream as jstream
from repro_torch import api
from repro_torch.data.synthetic import GMMSpec, gmm_chunk
from repro_torch.engine import faults
from repro_torch.engine import middleware as mw
from repro_torch.engine import scheduler as sched
from repro_torch.engine import stream
from repro_torch.kernels import ops
from test_torch_rng import REPLAY
from test_torch_stream import (
    RTOL, assert_same_fit, assert_same_trace, dataset, mixture_provider,
)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class Recorder:
    """A middleware for either package: each window's VNS rung, chunk size,
    accepts and winner size, and the final winner and stop reason."""

    def __init__(self):
        self.rows = []
        self.winner_s = self.stop_reason = None

    def on_start(self, ctx):
        pass

    def transform_chunk(self, ctx, cid, chunk):
        return chunk

    def on_fetch_error(self, ctx, cid, err):
        pass

    def should_stop(self, ctx):
        return False

    def after_window(self, ctx):
        self.rows.append((ctx.rung, ctx.last_s,
                          _np(ctx.info.accepted).reshape(-1).tolist(),
                          ctx.extras.get("winner_s")))

    def on_finish(self, ctx):
        self.winner_s = ctx.extras.get("winner_s")
        self.stop_reason = ctx.stop_reason


def run_pair(provider, cfg_kw, n_features, **kw):
    """``run_stream`` of both packages with the default stack, a
    :class:`Recorder` after it and the config's scheduler: ``((state,
    metrics, recorder, scheduler) of the reference, ... of the port)``."""
    out = []
    for engine, cfg, sched_mod, mw_mod, extra in (
            (jstream, japi.BigMeansConfig(impl="ref", **cfg_kw), jsched, jmw,
             {}),
            (stream, api.BigMeansConfig(**cfg_kw), sched, mw,
             dict(rng=REPLAY, key=REPLAY.key(cfg_kw.get("seed", 0)),
                  device="cpu"))):
        scheduler = sched_mod.get_scheduler(cfg.scheduler, cfg)
        rec = Recorder()
        state, m = engine.run_stream(
            provider(scheduler.fetch_s), cfg,
            n_features=n_features, scheduler=scheduler,
            middlewares=[*mw_mod.default_stack(cfg), rec], **kw, **extra)
        out.append((state, m, rec, scheduler))
    return out


def record_steps(monkeypatch):
    """Log every batched step of both packages' loops: ``(chunk ids,
    per-stream accepts)``, so persistent runs compare each stream's
    decisions (a window's ``ctx.info`` holds only its last size group)."""
    logs = {}
    for engine in (jstream, stream):
        log = logs.setdefault(engine, [])
        orig = engine._StepKernel.step_states

        def step_states(self, chunks, states, cids, orig=orig, log=log):
            out = orig(self, chunks, states, cids)
            log.append((list(cids), _np(out[1].accepted).reshape(-1)
                        .tolist()))
            return out

        monkeypatch.setattr(engine._StepKernel, "step_states", step_states)
    return logs[jstream], logs[stream]


def assert_same_run(ref, port):
    (jstate, jm, jrec, _), (state, m, rec, _) = ref, port
    for f in ("chunks_done", "chunks_failed", "chunks_dropped",
              "chunks_quarantined", "accepted", "lloyd_iters"):
        assert getattr(m, f) == getattr(jm, f), f
    assert_same_trace(m.trace, jm.trace)
    np.testing.assert_allclose(m.f_best, jm.f_best, rtol=RTOL)
    c = np.asarray(jstate.centroids)
    np.testing.assert_allclose(state.centroids.numpy(), c, rtol=RTOL,
                               atol=RTOL * float(np.abs(c).max()))
    assert [r[:3] for r in rec.rows] == [r[:3] for r in jrec.rows]
    assert rec.winner_s == jrec.winner_s
    assert rec.stop_reason == jrec.stop_reason


def array_provider(name):
    """``s -> provider`` over a quick dataset (both packages' ArraySource
    draw the same rows)."""
    spec, X = dataset(name)
    return spec, X, lambda s: japi.ArraySource(X).provider(s, seed=0)


# ---------------------------------------------------------------------------
# VNS ladder (fold mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,batch", [("hepmass-16k", 1),
                                        ("road3d-24k", 1),
                                        ("hepmass-16k", 3)])
def test_vns_fold_matches_reference(name, batch):
    """The same rung, chunk size and accepts every window, the same trace
    (ragged flushes at a rung change included); the ladder is used."""
    spec, X, provider = array_provider(name)
    cfg = dict(k=spec.k, s=spec.s, n_chunks=spec.n_chunks, batch=batch,
               vns_ladder=(1024, 512), vns_patience=3, log_every=1)
    ref, port = run_pair(provider, cfg, X.shape[1])
    assert_same_run(ref, port)
    rec = port[2]
    assert {r[1] for r in rec.rows} == {2048, 1024, 512}
    assert max(r[0] for r in rec.rows) == 2
    if (name, batch) != ("hepmass-16k", 1):
        return
    # fit() sends an in-core array with vns_ladder to streaming
    want = japi.fit(X, japi.BigMeansConfig(impl="ref", **cfg))
    got = api.fit(X, api.BigMeansConfig(**cfg), device="cpu", rng=REPLAY)
    assert got.extras["auto"] and want.strategy == "streaming"
    assert_same_fit(got, want)


def test_vns_needs_collective_sync():
    cfg = api.BigMeansConfig(k=5, s=512, n_chunks=4, batch=2, sync_every=2,
                             vns_ladder=(256,))
    jcfg = japi.BigMeansConfig(k=5, s=512, n_chunks=4, batch=2, sync_every=2,
                               vns_ladder=(256,))
    for engine, c, extra in ((jstream, jcfg, {}),
                             (stream, cfg, dict(device="cpu"))):
        with pytest.raises(ValueError, match="vns_ladder requires "
                                             "collective sync"):
            engine.run_stream(mixture_provider(), c, n_features=8, **extra)


def test_vns_ladder_middleware_steps():
    """A stall of ``patience`` unaccepted chunks escalates one rung (never
    past the last); an accept resets to the base rung."""
    lad = mw.VNSLadder(100, (50, 25), patience=2)
    ctx = mw.EngineContext(cfg=None, key=None, metrics=None)
    steps = [False, False, False, False, False, False, True]
    rungs = []
    for acc in steps:
        ctx.info = type("I", (), {"accepted": torch.tensor(acc)})
        lad.after_window(ctx)
        rungs.append(ctx.rung)
    assert rungs == [0, 1, 1, 2, 2, 2, 0]
    assert lad.transform_chunk(ctx, 0, torch.zeros(80, 3)).shape == (80, 3)
    ctx.rung = 2
    assert lad.transform_chunk(ctx, 0, torch.zeros(80, 3)).shape == (25, 3)


# ---------------------------------------------------------------------------
# competitive_s
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "int8", "bf16", "bf16x3"])
def test_competitive_s_matches_reference(precision, monkeypatch):
    """``batch=4, sync_every=2``, ladder (512, 1024, 2048): the same
    history (sizes, winner sizes, moves; eval scores within RTOL), final
    sizes, winner and every stream's accepts as the reference under every
    policy (the eval chunk is bf16 under bf16: B16 scores it there), and
    ``fit`` (at f32) reports the same ``extras["competitive_s"]``."""
    spec, X, provider = array_provider("hepmass-16k")
    cfg = dict(k=spec.k, s=1024, n_chunks=spec.n_chunks, batch=4,
               sync_every=2, scheduler="competitive_s",
               competitive_ladder=(512, 1024, 2048), precision=precision,
               log_every=1)
    want_steps, got_steps = record_steps(monkeypatch)
    ref, port = run_pair(provider, cfg, X.shape[1])
    assert_same_run(ref, port)
    assert got_steps == want_steps and len(got_steps) >= 6
    jhist, hist = ref[3].history, port[3].history
    assert len(hist) == len(jhist) == 3
    for h, jh in zip(hist, jhist):
        assert h["sizes"] == jh["sizes"] and h["winner_s"] == jh["winner_s"]
        assert h.get("moved") == jh.get("moved")
        assert list(h["eval_best"]) == list(jh["eval_best"])
        np.testing.assert_allclose(list(h["eval_best"].values()),
                                   list(jh["eval_best"].values()), rtol=RTOL)
    assert any("moved" in h for h in hist)
    assert port[3].s_of == ref[3].s_of
    assert [r[3] for r in port[2].rows] == [r[3] for r in ref[2].rows]
    if precision != "f32":
        return
    # through fit(): an in-core array goes to streaming, fetched at 2048
    want = japi.fit(X, japi.BigMeansConfig(impl="ref", **cfg))
    got = api.fit(X, api.BigMeansConfig(**cfg), device="cpu", rng=REPLAY)
    assert got.strategy == want.strategy == "streaming"
    assert_same_fit(got, want)
    assert got.extras["competitive_s"] == want.extras["competitive_s"]


def test_competitive_s_forces_persistent_streams(monkeypatch):
    """competitive_s runs persistent streams even at sync_every=1, and the
    eval set is never a quarantined chunk."""
    def provider(s):
        base = mixture_provider(s=s)

        def fetch(cid):
            chunk = base(cid)
            if cid == 7:                # the last chunk of the run
                chunk[0, 0] = np.nan
            return chunk
        return fetch

    cfg = dict(k=5, s=256, n_chunks=8, batch=2, sync_every=1,
               scheduler="competitive_s", competitive_ladder=(128, 256),
               log_every=1)
    want_steps, got_steps = record_steps(monkeypatch)
    ref, port = run_pair(provider, cfg, 8)
    assert_same_run(ref, port)
    assert got_steps == want_steps
    assert port[1].chunks_quarantined == 1


def test_uniform_and_worker_observe_nothing():
    """The stateless schedulers deal the configured s and never move a
    stream; the loop still calls them every window."""
    cfg = api.BigMeansConfig(k=5, s=512, batch=4, sync_every=2)
    for name in ("uniform", "worker"):
        s = sched.get_scheduler(name, cfg)
        assert s.sizes(4) == [512] * 4 and s.fetch_s == 512
        assert s.observe_window([1.0, 2.0, 3.0, 4.0], [512] * 4) == []
    calls = []

    class Spy(sched.Uniform):
        def observe_window(self, scores, sizes):
            calls.append(list(scores))
            return super().observe_window(scores, sizes)

    _, m = stream.run_stream(mixture_provider(), cfg.replace(n_chunks=16),
                             n_features=8, scheduler=Spy(cfg), device="cpu")
    assert m.chunks_done == 16 and len(calls) == 2     # 4 rounds, every 2
    assert all(len(c) == 4 for c in calls)
    assert sched.list_schedulers() == jsched.list_schedulers()


def test_competitive_s_stream_offset_deals_like_reference():
    for offset in (0, 1, 5):
        mine = sched.CompetitiveS(ladder=(300, 100, 200), batch=4,
                                  stream_offset=offset)
        ref = jsched.CompetitiveS(ladder=(300, 100, 200), batch=4,
                                  stream_offset=offset)
        assert mine.ladder == ref.ladder and mine.s_of == ref.s_of
    cfg = api.BigMeansConfig(k=5, s=1024, batch=4, scheduler="competitive_s")
    jcfg = japi.BigMeansConfig(k=5, s=1024, batch=4, scheduler="competitive_s")
    assert sched.default_ladder(5, 1024) == jsched.default_ladder(5, 1024)
    assert sched.get_scheduler("competitive_s", cfg).s_of == \
        jsched.get_scheduler("competitive_s", jcfg).s_of


# ---------------------------------------------------------------------------
# time budget (a scripted clock: one second a fetch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget,mode", [
    (4.5, dict(batch=3)), (5.5, dict(batch=3)), (2.5, dict()),
    (6.5, dict(batch=2, sync_every=2))],
    ids=["mid-batch", "after-flush", "sequential", "persistent"])
def test_time_budget_matches_reference(budget, mode, monkeypatch):
    """``time.monotonic`` patched to a clock that the provider advances by
    one second a fetch: the same stop window, ``budget_drop`` entries and
    reconciliation as the reference, no wall-clock race."""
    now = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    base = mixture_provider()

    def provider(s):
        def fetch(cid):
            now[0] += 1.0
            fetched.append(cid)
            return base(cid)
        return fetch

    cfg = dict(k=5, s=512, n_chunks=10, prefetch=0, seed=1, log_every=1,
               time_budget_s=budget, **mode)
    fetched: list = []
    ref, port = run_pair(provider, cfg, 8)
    assert_same_run(ref, port)
    m = port[1]
    assert port[2].stop_reason == "TimeBudget"
    assert m.chunks_done + m.chunks_failed + m.chunks_dropped \
        == len(fetched) // 2 < 10
    drops = [t for t in m.trace if t[0] == "budget_drop"]
    assert m.chunks_dropped == sum(len(t[1]) for t in drops)


def test_budget_stop_accounts_dropped_chunks():
    """tests/test_engine.py's test on the port (a real 0.6 s stall)."""
    data = gmm_chunk(GMMSpec(m=10**6, n=8, components=5, seed=3), 0, 512,
                     device="cpu").numpy()
    fetched = []

    def slow_provider(cid):
        fetched.append(cid)
        if cid == 2:
            time.sleep(0.6)
        return data

    cfg = api.BigMeansConfig(k=5, s=512, n_chunks=10, batch=3,
                             time_budget_s=0.3, prefetch=0, seed=1)
    _, m = stream.run_stream(slow_provider, cfg, n_features=8, device="cpu")
    drops = [t for t in m.trace if t[0] == "budget_drop"]
    assert m.chunks_dropped == sum(len(t[1]) for t in drops)
    assert m.chunks_done + m.chunks_failed + m.chunks_dropped == len(fetched)
    if m.chunks_dropped:
        assert drops and isinstance(drops[0][1], tuple)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 13])
def test_fault_plan_matches_reference(seed):
    """The same transient ids, launch faults and wrapped chunks (NaN, Inf,
    wrong shape) as the reference's plan, attempt by attempt."""
    kw = dict(seed=seed, transient_rate=0.3, transient_attempts=2,
              permanent_ids=(3,), nan_ids=(4,), inf_ids=(5,),
              shape_ids=(6,), launch_transient_rate=0.2,
              launch_outage_after=10, launch_outage_len=3)
    mine, ref = faults.FaultPlan(**kw), jfaults.FaultPlan(**kw)
    assert mine.transient_ids(200) == ref.transient_ids(200)
    assert [mine.is_launch_transient(i) for i in range(200)] == \
        [ref.is_launch_transient(i) for i in range(200)]
    assert [mine.in_outage(i) for i in range(20)] == \
        [ref.in_outage(i) for i in range(20)]
    base = mixture_provider(s=64)
    pw, rw = mine.wrap(base), ref.wrap(base)
    for cid in [*range(12), *range(12)]:
        outs = []
        for w in (pw, rw):
            try:
                outs.append(w(cid))
            except Exception as exc:    # noqa: BLE001 — compared below
                outs.append((type(exc).__name__, str(exc)))
        got, want = outs
        if isinstance(want, tuple):
            assert got == want
        else:
            assert got.shape == want.shape
            assert got.tobytes() == want.tobytes()
    assert pw.attempts == rw.attempts

    def launch(q, snap):
        return "ok"

    pl, rl = mine.wrap_launch(launch), ref.wrap_launch(launch)
    q = np.zeros((2, 3), np.float32)
    for i in range(30):
        payload = q if i != 4 else q + np.nan
        outs = []
        for f in (pl, rl):
            try:
                outs.append(f(payload, None))
            except Exception as exc:    # noqa: BLE001 — compared below
                outs.append((type(exc).__name__, str(exc)))
        assert outs[0] == outs[1], i
    assert pl.calls == rl.calls


def test_fault_plan_injector_matches_reference():
    kw = dict(seed=3, transient_rate=0.5, permanent_ids=(2,))
    mine, ref = faults.FaultPlan(**kw).injector(), \
        jfaults.FaultPlan(**kw).injector()
    for cid in [*range(8), *range(8)]:
        outs = []
        for inj in (mine, ref):
            try:
                outs.append(inj(cid))
            except Exception as exc:    # noqa: BLE001 — compared below
                outs.append(type(exc).__name__)
        assert outs[0] == outs[1], cid
    assert mine.attempts == ref.attempts


def test_chaos_run_matches_reference():
    """The chaos plan of ``tests/test_faults.py`` without its checkpoint
    half, with an Inf and a wrong-shape chunk too: the port's health record
    and trace are the reference's, every transient chunk recovered, and the
    objective within the reference's 5 % chaos gate of the clean fit."""
    plan = dict(seed=13, transient_rate=0.25, transient_attempts=1,
                permanent_ids=(12,), nan_ids=(14,), inf_ids=(20,),
                shape_ids=(22,))
    cfg = dict(k=5, s=512, n_chunks=24, prefetch=2, seed=1, retries=2,
               retry_backoff_s=0.0, fetch_timeout_s=5.0, log_every=1)
    base = mixture_provider()
    want_p = jfaults.FaultPlan(**plan).wrap(base)
    got_p = faults.FaultPlan(**plan).wrap(base)
    want = japi.fit(want_p, japi.BigMeansConfig(impl="ref", **cfg),
                    method="streaming", n_features=8)
    got = api.fit(got_p, api.BigMeansConfig(**cfg), method="streaming",
                  n_features=8, device="cpu", rng=REPLAY)
    assert_same_fit(got, want)
    assert got.health == want.health
    h = got.health
    assert (h["chunks_done"] + h["chunks_failed"] + h["chunks_dropped"]
            + h["chunks_quarantined"]) == h["chunks_fetched"] == 24
    assert h["chunks_failed"] == 1 and h["chunks_quarantined"] == 3
    assert [cid for cid, _ in h["quarantine_reasons"]] == [14, 20, 22]
    assert h["ckpt_fallback"] is None
    hit = faults.FaultPlan(**plan).transient_ids(24)
    assert hit
    assert all(got_p.attempts[cid] == 2 for cid in hit if cid != 12)
    assert got_p.attempts == want_p.attempts
    clean = api.fit(base, api.BigMeansConfig(**cfg), method="streaming",
                    n_features=8, device="cpu", rng=REPLAY)
    assert np.isfinite(got.objective)
    assert got.objective <= clean.objective * 1.05


# ---------------------------------------------------------------------------
# tests/test_faults.py, the non-checkpoint tests, on the port
# ---------------------------------------------------------------------------

SPEC = GMMSpec(m=10**5, n=8, components=5, seed=3)


def provider(cid):
    return gmm_chunk(SPEC, cid, 512, device="cpu").numpy()


def cfg_for(**kw):
    base = dict(k=5, s=512, n_chunks=8, prefetch=0, seed=1)
    base.update(kw)
    return api.BigMeansConfig(**base)


def run(prov, cfg, **kw):
    return stream.run_stream(prov, cfg, n_features=8, device="cpu", **kw)


def reconcile(m, fetched):
    assert (m.chunks_done + m.chunks_failed + m.chunks_dropped
            + m.chunks_quarantined) == fetched, m


def test_fault_plan_is_deterministic():
    plan = faults.FaultPlan(seed=11, transient_rate=0.3)
    again = faults.FaultPlan(seed=11, transient_rate=0.3)
    assert plan.transient_ids(64) == again.transient_ids(64)
    assert plan.transient_ids(64)
    other = faults.FaultPlan(seed=12, transient_rate=0.3)
    assert plan.transient_ids(256) != other.transient_ids(256)


def test_retry_policy_deterministic_bounded_backoff():
    pol = faults.RetryPolicy(retries=3, backoff_s=0.05, backoff_max_s=0.4,
                             seed=7)
    delays = [pol.delay(5, a) for a in range(6)]
    assert delays == [pol.delay(5, a) for a in range(6)]
    assert all(0.0 < d <= 0.4 for d in delays)
    assert pol.delay(5, 0) != pol.delay(6, 0)


def test_classify_taxonomy():
    assert faults.classify(RuntimeError("node lost")) == faults.TRANSIENT
    assert faults.classify(faults.FetchTimeout("hung")) == faults.TRANSIENT
    assert faults.classify(OSError("io")) == faults.TRANSIENT
    assert faults.classify(ValueError("bad")) == faults.PERMANENT
    assert faults.classify(KeyError("k")) == faults.PERMANENT
    assert faults.classify(NotImplementedError()) == faults.PERMANENT


def test_retry_recovers_transients_bitwise():
    plan = faults.FaultPlan(seed=5, transient_rate=0.4, transient_attempts=1)
    hit = plan.transient_ids(8)
    assert hit
    wrapped = plan.wrap(provider)
    st, m = run(wrapped, cfg_for(retries=2, retry_backoff_s=0.0))
    clean_st, _ = run(provider, cfg_for())
    assert m.chunks_done == 8 and m.chunks_failed == 0
    reconcile(m, 8)
    assert sum(wrapped.attempts.values()) == 8 + len(hit)
    assert torch.equal(st.centroids, clean_st.centroids)
    assert float(st.f_best) == float(clean_st.f_best)


def test_retries_zero_matches_legacy_drop_bitwise():
    bad = {2, 5}

    def flaky(cid):
        if cid in bad:
            raise RuntimeError(f"node lost {cid}")
        return provider(cid)

    def legacy_injector(cid):
        if cid in bad:
            raise RuntimeError(f"node lost {cid}")

    st, m = run(flaky, cfg_for())
    st_legacy, m_legacy = run(provider, cfg_for(),
                              fault_injector=legacy_injector)
    assert m.chunks_failed == len(bad) == m_legacy.chunks_failed
    assert sorted(t[1] for t in m.trace if t[0] == "fetch_error") == [2, 5]
    assert torch.equal(st.centroids, st_legacy.centroids)
    assert float(st.f_best) == float(st_legacy.f_best)


def test_permanent_faults_are_never_retried():
    plan = faults.FaultPlan(seed=0, permanent_ids=(3,))
    wrapped = plan.wrap(provider)
    _, m = run(wrapped, cfg_for(retries=3, retry_backoff_s=0.0))
    assert wrapped.attempts[3] == 1
    assert m.chunks_failed == 1
    errs = [t for t in m.trace if t[0] == "fetch_error" and t[1] == 3]
    assert errs and "PermanentFault" in errs[0][2]
    reconcile(m, 8)


def test_corrupt_chunks_quarantined_with_accounting():
    plan = faults.FaultPlan(seed=0, nan_ids=(1,), inf_ids=(4,),
                            shape_ids=(6,))
    st, m = run(plan.wrap(provider), cfg_for())
    assert m.chunks_quarantined == 3 and m.chunks_failed == 0
    reconcile(m, 8)
    q = {t[1]: t[2] for t in m.trace if t[0] == "quarantine"}
    assert set(q) == {1, 4, 6}
    assert "non-finite" in q[1] and "non-finite" in q[4]
    assert "shape" in q[6]
    assert np.isfinite(float(st.f_best))

    def failing(cid):
        if cid in (1, 4, 6):
            raise RuntimeError("boom")
        return provider(cid)

    st_drop, m_drop = run(failing, cfg_for())
    assert m_drop.chunks_failed == 3
    assert torch.equal(st.centroids, st_drop.centroids)
    assert float(st.f_best) == float(st_drop.f_best)


def test_quarantine_in_persistent_stream_mode():
    plan = faults.FaultPlan(seed=0, nan_ids=(3,))
    st, m = run(plan.wrap(provider), cfg_for(batch=2, sync_every=2))
    assert m.chunks_quarantined == 1
    assert ("quarantine", 3, "non-finite values (NaN/Inf)") in m.trace
    reconcile(m, 8)
    assert np.isfinite(float(torch.min(st.f_best)))


def test_watchdog_turns_hang_into_fault():
    never = threading.Event()

    def hung(cid):
        if cid == 2:
            never.wait(30.0)
        return provider(cid)

    t0 = time.monotonic()
    _, m = run(hung, cfg_for(fetch_timeout_s=0.25))
    assert time.monotonic() - t0 < 15.0
    assert m.chunks_done == 7 and m.chunks_failed == 1
    errs = [t for t in m.trace if t[0] == "fetch_error" and t[1] == 2]
    assert errs and "FetchTimeout" in errs[0][2]
    reconcile(m, 8)
    never.set()


def _prefetcher(prov, ids, depth, timeout=None):
    stats = {"fetch_ms": [], "stage_ms": [], "copy_ms": [], "wait_ms": []}
    stager = stream._Stager(torch.device("cpu"), "f32", stats)
    fetcher = stream._Fetcher(prov, None, stager, timeout=timeout)
    return stream._Prefetcher(fetcher, ids, depth, stats)


def test_prefetcher_close_reclaims_worker_with_hung_provider():
    never = threading.Event()

    def hung(cid):
        never.wait(30.0)
        return provider(cid)

    p = _prefetcher(hung, range(100), depth=2, timeout=0.2)
    cid, item = next(iter(p))
    assert cid == 0 and isinstance(item, stream._FetchFailure)
    assert "FetchTimeout" in item.error
    p.close()
    assert not p._thread.is_alive()
    never.set()


def test_prefetcher_close_is_idempotent_and_fast_mid_stream():
    p = _prefetcher(provider, range(1000), depth=2)
    next(iter(p))
    t0 = time.monotonic()
    p.close()
    p.close()
    assert time.monotonic() - t0 < 5.0
    assert not p._thread.is_alive()


def test_watchdog_timeout_is_retryable():
    calls = []

    def stalls_once(cid):
        calls.append(cid)
        if cid == 1 and calls.count(1) == 1:
            time.sleep(5.0)
        return provider(cid)

    _, m = run(stalls_once, cfg_for(n_chunks=3, fetch_timeout_s=0.3,
                                    retries=1, retry_backoff_s=0.0))
    assert m.chunks_done == 3 and m.chunks_failed == 0
    assert calls.count(1) == 2


_BURST_RUNS: dict = {}


@pytest.mark.parametrize("prefetch", [0, 2, 4])
def test_bursty_failures_reconcile_at_every_depth(prefetch):
    bad = {3, 4, 5}
    fetched = []

    def bursty(cid):
        fetched.append(cid)
        if cid in bad:
            raise RuntimeError(f"burst {cid}")
        return provider(cid)

    st, m = run(bursty, cfg_for(n_chunks=10, prefetch=prefetch))
    assert m.chunks_failed == 3 and m.chunks_done == 7
    reconcile(m, len(fetched))
    assert sorted(t[1] for t in m.trace if t[0] == "fetch_error") == [3, 4, 5]
    _BURST_RUNS[prefetch] = (st.centroids.clone(), float(st.f_best))


def test_bursty_failure_trajectories_match_across_depths():
    assert set(_BURST_RUNS) == {0, 2, 4}, "parametrized test must run first"
    c0, f0 = _BURST_RUNS[0]
    for depth in (2, 4):
        c, f = _BURST_RUNS[depth]
        assert torch.equal(c0, c) and f0 == f


def _guard_ctx(f_best, last_s=512, mode="fold"):
    st = type("State", (), {"f_best": torch.tensor(f_best,
                                                   dtype=torch.float32)})
    ctx = mw.EngineContext(cfg=None, key=None, metrics=None, state=st,
                           last_s=last_s)
    ctx.extras["stream_mode"] = mode
    return ctx


def test_invariant_guard_rejects_nan_and_neg_inf():
    guard = mw.InvariantGuard()
    with pytest.raises(faults.InvariantViolation, match="poisoned"):
        guard.after_window(_guard_ctx(float("nan")))
    with pytest.raises(faults.InvariantViolation, match="poisoned"):
        guard.after_window(_guard_ctx(-float("inf")))


def test_invariant_guard_rejects_rising_incumbent_in_fold_mode():
    guard = mw.InvariantGuard()
    guard.after_window(_guard_ctx(100.0))
    guard.after_window(_guard_ctx(90.0))
    with pytest.raises(faults.InvariantViolation, match="rose"):
        guard.after_window(_guard_ctx(140.0))


def test_invariant_guard_tolerates_rescale_and_persistent_mode():
    guard = mw.InvariantGuard()
    guard.after_window(_guard_ctx(100.0, last_s=512))
    guard.after_window(_guard_ctx(200.0, last_s=1024))
    guard2 = mw.InvariantGuard()
    guard2.after_window(_guard_ctx(10.0, mode="persistent"))
    guard2.after_window(_guard_ctx(50.0, mode="persistent"))


# ---------------------------------------------------------------------------
# tests/test_engine.py's scheduler tests on the port
# ---------------------------------------------------------------------------

ENGINE_SPEC = GMMSpec(m=10**6, n=8, components=5, seed=3)


def engine_provider(cid):
    return gmm_chunk(ENGINE_SPEC, cid, 1024, device="cpu").numpy()


def test_worker_scheduler_streams_like_uniform():
    cfg = api.BigMeansConfig(k=5, s=1024, n_chunks=8, batch=2, sync_every=2,
                             scheduler="worker", prefetch=0, seed=1)
    r = api.fit(engine_provider, cfg, method="streaming", n_features=8,
                device="cpu")
    assert r.n_chunks == 8 and np.isfinite(r.objective)
    u = api.fit(engine_provider, cfg.replace(scheduler="uniform"),
                method="streaming", n_features=8, device="cpu")
    assert torch.equal(r.centroids, u.centroids) and r.trace == u.trace


def test_competitive_s_registered():
    assert "competitive_s" in sched.list_schedulers()
    s = sched.get_scheduler("competitive_s", api.BigMeansConfig(
        k=5, s=1024, batch=4, scheduler="competitive_s"))
    assert isinstance(s, sched.CompetitiveS)
    assert s.fetch_s == max(s.ladder)


def test_competitive_s_reallocates_toward_winner():
    s = sched.CompetitiveS(ladder=(256, 512, 1024), batch=6)
    sizes = s.sizes(6)
    f = [1.0 if z == 512 else (3.0 if z == 1024 else 2.0) for z in sizes]
    moves = s.observe_window(f, sizes)
    assert len(moves) == 1
    b, new_s, clone_from = moves[0]
    assert new_s == 512 and sizes[b] == 1024 and sizes[clone_from] == 512
    assert s.s_of.count(512) == sizes.count(512) + 1


def test_competitive_s_end_to_end():
    X = gmm_chunk(GMMSpec(m=8000, n=8, components=5, seed=21), 0, 8000,
                  device="cpu").numpy()
    cfg = api.BigMeansConfig(k=5, s=1024, n_chunks=24, batch=4, sync_every=2,
                             scheduler="competitive_s",
                             competitive_ladder=(512, 1024, 2048), seed=1)
    r = api.fit(X, cfg, method="streaming", device="cpu")
    assert r.n_chunks == 24
    info = r.extras["competitive_s"]
    assert info["ladder"] == (512, 1024, 2048)
    assert info["windows"] >= 1
    assert len(info["final_sizes"]) == 4
    assert np.isfinite(r.objective)


def test_competitive_s_validation():
    with pytest.raises(ValueError, match="batch >= 2"):
        api.BigMeansConfig(k=5, s=1024, batch=1, scheduler="competitive_s")
    with pytest.raises(ValueError, match="unknown scheduler"):
        api.BigMeansConfig(k=5, s=1024, scheduler="nope")


# ---------------------------------------------------------------------------
# the fit surface: auto, health, FitResult, kernel_failure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob", [
    dict(), dict(batch=2), dict(time_budget_s=5.0), dict(vns_ladder=(200,)),
    dict(batch=2, scheduler="competitive_s"), dict(scheduler="worker")],
    ids=["plain", "batch", "time_budget_s", "vns_ladder", "competitive_s",
         "worker"])
def test_resolve_auto_matches_reference(knob):
    X = np.zeros((1000, 3), np.float32)
    cfg = dict(k=3, s=400, n_chunks=4, **knob)
    assert api.resolve_auto(api.BigMeansConfig(**cfg), api.as_source(X)) \
        == japi.resolve_auto(japi.BigMeansConfig(**cfg), japi.as_source(X))


def test_health_keys_and_fit_result_methods_match_reference():
    """The same health record (key set and values), and ``to_row()`` /
    ``summary()`` equal to the reference's up to the objective's float and
    the wall."""
    cfg = dict(k=5, s=512, n_chunks=6, seed=2, log_every=1)
    want = japi.fit(mixture_provider(), japi.BigMeansConfig(impl="ref", **cfg),
                    method="streaming", n_features=8)
    got = api.fit(mixture_provider(), api.BigMeansConfig(**cfg),
                  method="streaming", n_features=8, device="cpu", rng=REPLAY)
    assert set(got.health) == set(want.health)
    assert got.health == want.health
    assert "kernel_fallbacks" not in got.health
    assert (got.k, got.n_features) == (want.k, want.n_features) == (5, 8)
    row, want_row = got.to_row(), want.to_row()
    assert set(row) == set(want_row)
    for key in set(row) - {"objective", "n_dist_evals", "wall_time_s",
                           "fit"}:
        assert row[key] == want_row[key], key
    for key in ("objective", "n_dist_evals"):
        np.testing.assert_allclose(row[key], want_row[key], rtol=RTOL)
    for key in ("method", "autotune", "seed", "source"):
        assert row["fit"][key] == want_row["fit"][key], key

    def fields(s):
        return re.sub(r"(f|n_d|wall)=\S+", r"\1=*", s), \
            [float(v) for v in re.findall(r"(?:f|n_d)=(\S+)", s)]

    (text, nums), (want_text, want_nums) = (fields(got.summary()),
                                            fields(want.summary()))
    assert text == want_text
    np.testing.assert_allclose(nums, want_nums, rtol=1e-3)
    in_core = api.fit(mixture_provider()(0), api.BigMeansConfig(**cfg),
                      device="cpu")
    assert in_core.health is None and "n_d=" in in_core.summary()


def test_kernel_failure_swaps_every_policy():
    """Inside ``kernel_failure(op)`` every policy's wrapper of that entry
    point raises the injected error; on exit the wrappers are back.  The
    plain path on the CPU launches no kernel, so a fit there is bitwise the
    fit outside the context."""
    entry = {"assign": "assign", "update": "update", "fused": "fused",
             "fused_batched": "batched"}
    before = {p: dict(t) for p, t in ops._KERNELS.items()}
    cfg = api.BigMeansConfig(k=5, s=512, n_chunks=3, seed=1)
    X = mixture_provider()(0)
    clean = api.fit(X, cfg, device="cpu")
    for op, name in entry.items():
        with faults.kernel_failure(op):
            for prec, table in ops._KERNELS.items():
                assert table[name] is not before[prec][name]
                with pytest.raises(RuntimeError,
                                   match=f"injected {op} kernel failure"):
                    table[name](None, None)
            res = api.fit(X, cfg, device="cpu")
        assert {p: dict(t) for p, t in ops._KERNELS.items()} == before
        assert torch.equal(res.centroids, clean.centroids)
    with pytest.raises(KeyError):
        with faults.kernel_failure("nope"):
            pass
    with pytest.raises(ValueError, match="boom"):
        with faults.kernel_failure("fused", ValueError("boom")):
            ops._KERNELS["int8"]["fused"]()
    assert {p: dict(t) for p, t in ops._KERNELS.items()} == before
