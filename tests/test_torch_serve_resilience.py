"""repro_torch.serve resilience against repro.serve's: typed failure,
isolation, supervision.

Held to the reference on the same inputs: the circuit breaker's state
machine, events and seeded probe delays (trips 1-6), the
``FaultPlan.wrap_launch`` fault schedule (the same ``(seed, launch_index)``
gives the same kinds of fault), and ``Server.health()``'s keys.  The rest
mirrors ``tests/test_serve_resilience.py`` on the port (``device="cpu"``):

* no request future is ever stranded — a crashed worker fails its pending
  futures with ``WorkerCrashed`` and restarts;
* ``assign(timeout=)`` cancels its queued request on timeout;
* a non-finite payload is a typed client error at submit time; with
  validation off, bisection isolates the poisoned request at launch time
  and its coalesced neighbours are served bitwise as in a fault-free run
  (the reference's twin of this test fails: it compares with its oracle at
  the request's own shape, whose last bits XLA's CPU dot changes);
* deadlines shed expired requests, the config's default deadline too;
* per-tenant quotas bound one noisy tenant without starving others;
* the breaker trips, fast-fails, probes half-open and closes end to end;
* transient launch faults recover bitwise by relaunching the same launch
  (``ModelEntry.relaunch``, which ``wrap_launch`` leaves alone, as the
  reference's ref-path retry); repeated primary failures demote the bucket
  (this model's only; on the CPU it runs the ref path as the reference's
  does, on the card its requests fail: ``test_torch_cuda.py``);
* the watcher survives exceptions, and its watchdog abandons a poll that
  ``faults.hung_restore`` stalls.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.engine import faults as jfaults
from repro.serve.resilience import CircuitBreaker as JCircuitBreaker
from repro_torch.cluster import checkpoint
from repro_torch.core import bigmeans
from repro_torch.engine import faults
from repro_torch.kernels import ref
from repro_torch.serve import (
    CheckpointWatcher,
    CircuitBreaker,
    DeadlineExceeded,
    InvalidRequest,
    LaunchFault,
    ModelRegistry,
    ModelUnhealthy,
    QueueFull,
    QuotaExceeded,
    ServeConfig,
    WorkerCrashed,
    serve,
)
from repro_torch.serve.resilience import CLOSED, HALF_OPEN, OPEN


def _centroids(k: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 3.0


def _points(m: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _oracle(points, centroids):
    """The port's plain assign on the request alone, at 8 rows or more
    (``test_torch_serve.MIN_ROWS``)."""
    x = np.zeros((max(len(points), 8), points.shape[1]), np.float32)
    x[:len(points)] = points
    ids, d = ref.assign_ref(torch.from_numpy(x), torch.from_numpy(centroids))
    return ids.numpy()[:len(points)], d.numpy()[:len(points)]


def _quick(**overrides) -> dict:
    base = dict(min_bucket=8, max_batch=64, max_linger_ms=2.0,
                queue_depth=64)
    base.update(overrides)
    return base


def _serve(models, **overrides):
    return serve(models, ServeConfig(**_quick(**overrides)), device="cpu")


def _gate_launch(entry):
    """Block the worker's launches on an Event (release with .set())."""
    gate = threading.Event()
    original = entry.launch

    def gated(q, snap):
        gate.wait(10.0)
        return original(q, snap)

    entry.launch = gated
    return gate


def _drain(batcher, timeout=5.0):
    t0 = time.monotonic()
    while batcher.queue_depth() and time.monotonic() - t0 < timeout:
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the breaker and the fault schedule, against the reference's


def _breaker_run(cls, seed: int):
    """Drive a breaker through six trips under a fake clock: its events
    and, after each trip, its probe delay."""
    t = [0.0]
    events = []
    br = cls("m", threshold=3, backoff_s=1.0, backoff_max_s=8.0, seed=seed,
             clock=lambda: t[0], on_event=events.append)
    delays = []
    for _ in range(3):
        br.record_failure("f")
    for trip in range(1, 7):
        assert br.state == OPEN and br.trips == trip
        delays.append(br.retry_in_s())
        assert not br.allow()
        t[0] += delays[-1]
        assert br.allow() and br.state == HALF_OPEN
        assert not br.allow()                     # probe already in flight
        if trip < 6:
            br.record_failure("probe failed")
    br.record_success()
    assert br.state == CLOSED and br.failures == 0
    return events, delays, br.describe()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_breaker_matches_reference(seed):
    """Trips 1-6 under a fake clock: the same events and bitwise the same
    seeded probe delays as the reference's ``CircuitBreaker``."""
    got = _breaker_run(CircuitBreaker, seed)
    assert got == _breaker_run(JCircuitBreaker, seed)
    events, delays, _ = got
    assert [e[0] for e in events[:3]] == ["breaker_open", "breaker_probe",
                                          "breaker_open"]
    assert events[-1] == ("breaker_close", "m", 6)
    for trip, delay in enumerate(delays, 1):
        base = min(2.0 ** (trip - 1), 8.0)
        assert 0.5 * base <= delay <= base


def test_breaker_state_machine_with_fake_clock():
    t = [0.0]
    events = []
    br = CircuitBreaker("m", threshold=3, backoff_s=1.0, backoff_max_s=8.0,
                        seed=7, clock=lambda: t[0], on_event=events.append)
    assert br.allow() and br.state == CLOSED
    br.record_failure("f1")
    br.record_failure("f2")
    assert br.allow()                             # still under threshold
    br.record_failure("f3")
    assert br.state == OPEN and not br.allow()
    assert 0.0 < br.retry_in_s() <= 1.0
    t[0] = 1.0
    assert br.allow() and br.state == HALF_OPEN
    assert not br.allow()
    br.record_failure("probe failed")
    assert br.state == OPEN and br.trips == 2
    assert br.retry_in_s() <= 2.0
    t[0] = 3.0
    assert br.allow()
    br.record_success()
    assert br.state == CLOSED and br.failures == 0
    assert [e[0] for e in events] == ["breaker_open", "breaker_probe",
                                      "breaker_open", "breaker_probe",
                                      "breaker_close"]
    off = CircuitBreaker("m", threshold=0)
    for _ in range(10):
        off.record_failure()
    assert off.allow() and off.state == CLOSED


def _schedule(plan, launches: int, poison_at=()):
    """The kind of fault each launch index raises ('ok' when none)."""
    wrapped = plan.wrap_launch(lambda q, snap: "ok")
    kinds = []
    for i in range(launches):
        q = np.zeros((8, 3), np.float32)
        if i in poison_at:
            q[2, 1] = np.nan
        try:
            kinds.append(wrapped(q, None))
        except Exception as exc:  # noqa: BLE001 — the kind is the result
            kinds.append(type(exc).__name__)
    assert wrapped.calls["n"] == launches
    return kinds


@pytest.mark.parametrize("knobs", [
    dict(seed=3, launch_transient_rate=0.3),
    dict(seed=11, launch_transient_rate=0.5, launch_outage_after=7,
         launch_outage_len=5),
    dict(seed=0, launch_transient_rate=1.0),
    dict(seed=5, launch_outage_after=0, launch_outage_len=3)],
    ids=["transient", "outage", "always", "outage_first"])
def test_wrap_launch_schedule_matches_reference(knobs):
    """The same ``(seed, launch_index)`` faults the same launches with the
    same kinds as the reference's plan, poisoned payloads included; the
    port's check reads host buffers (numpy or CPU tensors) alike."""
    poison = (4, 9)
    got = _schedule(faults.FaultPlan(**knobs), 40, poison)
    assert got == _schedule(jfaults.FaultPlan(**knobs), 40, poison)
    assert got[4] == got[9] == "PermanentFault"
    wrapped = faults.FaultPlan(seed=1).wrap_launch(lambda q, snap: "ok")
    bad = torch.zeros((8, 3))
    bad[0, 0] = float("inf")
    with pytest.raises(faults.PermanentFault, match="non-finite payload"):
        wrapped(bad, None)
    assert wrapped(torch.zeros((8, 3)), None) == "ok"


# ---------------------------------------------------------------------------
# supervision: no stranded futures, ever


def test_worker_crash_fails_pending_futures_and_restarts():
    C = _centroids(6, 4)
    with _serve({"m": C}) as srv:
        batcher = srv._batchers["m"]
        original = batcher._launch_batch

        def boom(batch):
            batcher._launch_batch = original       # crash exactly once
            raise RuntimeError("injected worker crash")

        batcher._launch_batch = boom
        fut = srv.submit("m", _points(3, 4, seed=1))
        with pytest.raises(WorkerCrashed):
            fut.result(timeout=5.0)
        resp = srv.assign("m", _points(5, 4, seed=2), timeout=5.0)
        assert np.array_equal(resp.ids, _oracle(_points(5, 4, seed=2), C)[0])
        assert batcher.worker_alive()
        assert batcher.stats.worker_restarts == 1
        assert any(e[0] == "worker_restart" and e[1] == "m"
                   for e in srv.trace)
        assert srv.health()["models"]["m"]["worker_restarts"] == 1


def test_close_after_crash_still_clean():
    srv = _serve({"m": _centroids(4, 3)})
    batcher = srv._batchers["m"]
    batcher._launch_batch = lambda batch: (_ for _ in ()).throw(
        RuntimeError("always crash"))
    with pytest.raises(WorkerCrashed):
        srv.submit("m", _points(2, 3, seed=0)).result(timeout=5.0)
    srv.close()
    assert not batcher.worker_alive()


# ---------------------------------------------------------------------------
# assign(timeout=): cancel, don't strand


def test_assign_timeout_cancels_queued_request():
    with _serve({"m": _centroids(5, 4)}) as srv:
        entry = srv.registry.get("m")
        batcher = srv._batchers["m"]
        gate = _gate_launch(entry)
        blocker = srv.submit("m", _points(2, 4, seed=0))
        time.sleep(0.05)                          # worker now inside launch
        with pytest.raises(DeadlineExceeded):
            srv.assign("m", _points(2, 4, seed=1), timeout=0.05)
        assert batcher.queue_depth() == 0
        assert batcher.stats.n_cancelled == 1
        gate.set()
        blocker.result(timeout=5.0)
        _drain(batcher)
        assert len(batcher.stats.latencies_ms) == 1


def test_cancelled_request_burns_no_launch():
    with _serve({"m": _centroids(5, 4)}) as srv:
        entry = srv.registry.get("m")
        gate = _gate_launch(entry)
        blocker = srv.submit("m", _points(2, 4, seed=0))
        time.sleep(0.05)
        fut = srv.submit("m", _points(2, 4, seed=1))
        assert srv._batchers["m"].cancel(fut)
        launches = []
        original = entry.launch

        def counting(q, snap):
            launches.append(int(q.shape[0]))
            return original(q, snap)

        entry.launch = counting
        gate.set()
        blocker.result(timeout=5.0)
        assert fut.cancelled()
        assert len(launches) <= 1


# ---------------------------------------------------------------------------
# admission validation and deadlines


def test_non_finite_request_rejected_at_submit():
    with _serve({"m": _centroids(4, 3)}) as srv:
        bad = _points(4, 3, seed=0)
        bad[2, 1] = np.nan
        with pytest.raises(InvalidRequest):
            srv.submit("m", bad)
        inf = _points(4, 3, seed=1)
        inf[0, 0] = np.inf
        with pytest.raises(InvalidRequest):
            srv.assign("m", inf)
        assert srv.stats("m")["n_invalid"] == 2
        # Trusted-client override: admitted (the ref path tolerates NaN).
        resp = srv.assign("m", bad, validate=False, timeout=5.0)
        assert resp.ids.shape == (4,)


def test_deadline_must_be_positive():
    with _serve({"m": _centroids(4, 3)}) as srv:
        with pytest.raises(ValueError):
            srv.submit("m", _points(2, 3, seed=0), deadline_ms=0)


def test_deadlines_shed_expired_requests_under_saturation():
    C = _centroids(5, 4)
    with _serve({"m": C}) as srv:
        entry = srv.registry.get("m")
        batcher = srv._batchers["m"]
        gate = _gate_launch(entry)
        blocker = srv.submit("m", _points(2, 4, seed=0))
        time.sleep(0.05)
        doomed = srv.submit("m", _points(2, 4, seed=1), deadline_ms=40.0)
        healthy = srv.submit("m", _points(2, 4, seed=2))
        time.sleep(0.12)                          # doomed is now expired
        gate.set()
        blocker.result(timeout=5.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=5.0)
        resp = healthy.result(timeout=5.0)
        assert np.array_equal(resp.ids, _oracle(_points(2, 4, seed=2), C)[0])
        assert batcher.stats.n_deadline_shed == 1
        shed = [e for e in srv.trace if e[0] == "deadline_shed"]
        assert len(shed) == 1 and shed[0][1] == "m" and shed[0][2] > 0


def test_default_deadline_from_config():
    with _serve({"m": _centroids(5, 4)}, default_deadline_ms=40.0) as srv:
        gate = _gate_launch(srv.registry.get("m"))
        blocker = srv.submit("m", _points(2, 4, seed=0))
        time.sleep(0.05)
        doomed = srv.submit("m", _points(2, 4, seed=1))  # inherits 40ms
        time.sleep(0.12)
        gate.set()
        blocker.result(timeout=5.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=5.0)


def test_tenant_quota_bounds_one_tenant_not_others():
    with _serve({"m": _centroids(4, 3)}, tenant_quota=2) as srv:
        gate = _gate_launch(srv.registry.get("m"))
        blocker = srv.submit("m", _points(2, 3, seed=0), tenant="noisy")
        time.sleep(0.05)
        futs = [srv.submit("m", _points(2, 3, seed=i), tenant="noisy")
                for i in (1, 2)]
        with pytest.raises(QuotaExceeded) as exc_info:
            srv.submit("m", _points(2, 3, seed=3), tenant="noisy")
        assert isinstance(exc_info.value, QueueFull)
        quiet = srv.submit("m", _points(2, 3, seed=4), tenant="quiet")
        gate.set()
        for f in [blocker, quiet] + futs:
            f.result(timeout=5.0)
        assert srv.stats("m")["n_quota_rejected"] == 1
        srv.assign("m", _points(2, 3, seed=5), tenant="noisy", timeout=5.0)


# ---------------------------------------------------------------------------
# the breaker end to end


def test_breaker_trips_fast_fails_and_recovers_end_to_end():
    C = _centroids(5, 4)
    with _serve({"m": C}, breaker_threshold=3, breaker_backoff_s=0.05,
                breaker_backoff_max_s=0.05, launch_retries=0) as srv:
        entry = srv.registry.get("m")
        original = entry.launch

        def dead(q, snap):
            raise faults.PermanentFault("injected model outage")

        entry.launch = dead
        entry.relaunch = dead
        for i in range(3):
            with pytest.raises(LaunchFault):
                srv.assign("m", _points(2, 4, seed=i), timeout=5.0)
        with pytest.raises(ModelUnhealthy) as exc_info:
            srv.submit("m", _points(2, 4, seed=9))
        assert exc_info.value.retry_in_s > 0
        health = srv.health()
        assert health["models"]["m"]["breaker"]["state"] == OPEN
        assert not health["ok"]
        entry.launch = original
        del entry.relaunch                        # restore class method
        time.sleep(0.08)
        resp = srv.assign("m", _points(3, 4, seed=10), timeout=5.0)
        assert np.array_equal(resp.ids,
                              _oracle(_points(3, 4, seed=10), C)[0])
        health = srv.health()
        assert health["models"]["m"]["breaker"]["state"] == CLOSED
        assert health["ok"]
        kinds = [e[0] for e in srv.trace]
        assert "breaker_open" in kinds and "breaker_probe" in kinds \
            and "breaker_close" in kinds
        assert srv.stats("m")["n_breaker_rejected"] == 1


# ---------------------------------------------------------------------------
# fault-isolated launches


def _coalesced_behind_blocker(srv, reqs, validate):
    """Submit ``reqs`` while a gated launch holds the worker, so they
    coalesce into one launch; returns their futures."""
    entry = srv.registry.get("m")
    gate = _gate_launch(entry)
    blocker = srv.submit("m", _points(2, 4, seed=0))
    time.sleep(0.05)
    futs = [srv.submit("m", p, validate=v) for p, v in zip(reqs, validate)]
    gate.set()
    blocker.result(timeout=5.0)
    return futs


def test_bisection_isolates_poisoned_request_bitwise():
    """Only the poisoned request fails, and its coalesced neighbours are
    bitwise the same requests served by a fault-free server."""
    C = _centroids(6, 4)
    healthy_pts = [_points(3, 4, seed=10 + i) for i in range(4)]
    poison = _points(3, 4, seed=99)
    poison[1, 2] = np.nan
    reqs = healthy_pts[:2] + [poison] + healthy_pts[2:]
    validate = [None, None, False, None, None]
    with _serve({"m": C}, max_linger_ms=100.0, launch_retries=0) as clean:
        want = [f.result(timeout=10.0) for f in _coalesced_behind_blocker(
            clean, healthy_pts, [None] * 4)]
    with _serve({"m": C}, max_linger_ms=100.0, launch_retries=0) as srv:
        entry = srv.registry.get("m")
        entry.launch = faults.FaultPlan(seed=3).wrap_launch(entry.launch)
        futs = _coalesced_behind_blocker(srv, reqs, validate)
        with pytest.raises(LaunchFault):
            futs[2].result(timeout=10.0)
        got = [f.result(timeout=10.0) for f in futs[:2] + futs[3:]]
        assert srv.stats("m")["n_failed"] == 1
        assert any(e[0] == "launch_fault" for e in srv.trace)
        assert srv.health()["models"]["m"]["breaker"]["state"] == CLOSED
    assert max(r.n_coalesced for r in got) > 1
    for pts, r, w in zip(healthy_pts, got, want):
        assert np.array_equal(r.ids, w.ids)
        assert np.array_equal(r.dists, w.dists)
        ids, dists = _oracle(pts, C)
        assert np.array_equal(r.ids, ids) and np.array_equal(r.dists, dists)


def test_transient_launch_faults_recover_on_ref_path_bitwise():
    """A transient fault retries the same launch (``relaunch``), never the
    ref fallback, which on the card would be the plain version."""
    C = _centroids(5, 4)
    with _serve({"m": C}, launch_retries=1, demote_after=0) as srv:
        entry = srv.registry.get("m")
        plan = faults.FaultPlan(seed=0, launch_transient_rate=1.0)
        entry.launch = plan.wrap_launch(entry.launch)

        def no_fallback(q, snap):
            raise AssertionError("a transient retry took the fallback")

        entry.launch_fallback = no_fallback
        for i in range(4):
            pts = _points(6, 4, seed=i)
            resp = srv.assign("m", pts, timeout=5.0)
            ids, dists = _oracle(pts, C)
            assert np.array_equal(resp.ids, ids)
            assert np.array_equal(resp.dists, dists)
        stats = srv.stats("m")
        assert stats["n_ref_retries"] == 4 and stats["n_launch_faults"] == 4
        assert stats["n_failed"] == 0
        assert srv.health()["models"]["m"]["breaker"]["state"] == CLOSED
        assert srv.health()["models"]["m"]["demoted_buckets"] == []


def test_repeated_primary_failures_demote_bucket():
    C = _centroids(5, 4)
    with _serve({"m": C}, launch_retries=1, demote_after=2) as srv, \
            _serve({"m": C}) as other:
        entry = srv.registry.get("m")
        plan = faults.FaultPlan(seed=0, launch_transient_rate=1.0)
        entry.launch = plan.wrap_launch(entry.launch)
        for i in range(3):
            srv.assign("m", _points(6, 4, seed=i), timeout=5.0)
        assert entry.demoted_buckets == (8,)
        assert srv.health()["models"]["m"]["demoted_buckets"] == [8]
        calls_before = entry.launch.calls["n"]
        resp = srv.assign("m", _points(6, 4, seed=9), timeout=5.0)
        assert np.array_equal(resp.ids, _oracle(_points(6, 4, seed=9), C)[0])
        assert entry.launch.calls["n"] == calls_before
        # per entry: another server's model at the same shape is untouched
        assert other.health()["models"]["m"]["demoted_buckets"] == []
        assert other.stats("m")["replays"] == {}
        other.assign("m", _points(6, 4, seed=9), timeout=5.0)
        assert other.stats("m")["replays"] == {8: 1}


# ---------------------------------------------------------------------------
# watcher supervision


def _save_engine_ckpt(directory: str, step: int, centroids: np.ndarray):
    k, n = centroids.shape
    state = bigmeans.init_state(k, n, device="cpu")._replace(
        centroids=torch.from_numpy(centroids),
        f_best=torch.tensor(1.0))
    checkpoint.save(directory, step, ((state, np.zeros(2, np.uint32)),
                                      np.zeros(3, np.int64)))


def test_watcher_survives_poll_exceptions(monkeypatch):
    registry = ModelRegistry(device="cpu")
    registry.register("m", _centroids(4, 3))
    w = CheckpointWatcher(registry, "m", "/nonexistent",
                          poll_interval_s=0.01, poll_timeout_s=None)

    def explode(_):
        raise OSError("injected scan failure")

    monkeypatch.setattr(checkpoint, "latest_intact_step", explode)
    w.start()
    time.sleep(0.1)
    assert w.alive()
    assert w.n_errors > 0
    assert "injected scan failure" in w.last_error
    w.stop()
    assert not w.alive()
    d = w.describe()
    assert d["n_errors"] == w.n_errors and d["model_id"] == "m"


def test_watcher_watchdog_abandons_hung_poll(tmp_path):
    d = str(tmp_path / "ckpt")
    C = _centroids(4, 3)
    C2 = _centroids(4, 3, seed=1)
    _save_engine_ckpt(d, 1, C)
    registry = ModelRegistry(device="cpu")
    registry.register("m", C)
    w = CheckpointWatcher(registry, "m", d, poll_interval_s=0.02,
                          poll_timeout_s=0.1)
    with faults.hung_restore():                   # loads hang until exit
        w.start()
        _save_engine_ckpt(d, 2, C2)               # a new step appears...
        t0 = time.monotonic()
        while w.stalled_polls == 0 and time.monotonic() - t0 < 5.0:
            time.sleep(0.01)
        # ...but its load hangs: the watchdog abandoned the poll.
        assert w.stalled_polls >= 1
        assert w.alive()
        assert w.n_swaps == 0
        assert "stalled" in w.last_error
        assert any(e[0] == "watcher_stall" for e in registry.trace)
    t0 = time.monotonic()
    while w.last_step != 2 and time.monotonic() - t0 < 5.0:
        time.sleep(0.02)
    assert w.n_swaps >= 1 and w.last_step == 2
    assert np.array_equal(registry.get("m").snapshot().centroids.numpy(), C2)
    w.stop()


# ---------------------------------------------------------------------------
# health aggregation


def test_health_shape_and_ok_match_reference():
    C, Cb = _centroids(4, 3), _centroids(5, 3, seed=2)
    cfg = _quick()
    with serve({"a": C, "b": Cb}, ServeConfig(**cfg), device="cpu") as srv, \
            jserve.serve({"a": C, "b": Cb},
                         jserve.ServeConfig(**cfg, warmup=False)) as jsrv:
        srv.assign("a", _points(3, 3, seed=0), timeout=5.0)
        jsrv.assign("a", _points(3, 3, seed=0), timeout=5.0)
        health, want = srv.health(), jsrv.health()
        assert health["ok"] is True and want["ok"] is True
        assert set(health) == set(want)
        assert set(health["models"]) == set(want["models"]) == {"a", "b"}
        m = health["models"]["a"]
        assert set(m) == set(want["models"]["a"])
        assert set(m["breaker"]) == set(want["models"]["a"]["breaker"])
        assert m["queue_depth"] == 0
        assert m["worker_alive"] is True
        assert m["worker_restarts"] == 0
        assert m["breaker"]["state"] == CLOSED
        assert m["demoted_buckets"] == []
        assert m["last_swap_age_s"] >= 0
        assert health["watchers"] == []
        json.dumps(health)
        assert set(srv.stats("a")) >= set(jsrv.stats("a"))
