"""repro_torch.serve against repro.serve: batching, tenancy, hot swap.

Both packages serve the same seeded numpy inputs on the CPU (the port with
``device="cpu"``: every launch is the plain PyTorch version).  Held to the
reference:

* ``ServeConfig`` accepts and refuses the same knobs with the same
  messages, and ``buckets()`` agree;
* each response's ids equal the reference server's response, and its
  distances agree within ``RTOL``: the reference's bucket-padded jitted
  launch does not give bitwise the distances of its own oracle at the
  request's unpadded shape (XLA's CPU dot associates differently at
  another ``m``), which is why the reference's
  ``test_hot_swap_under_concurrent_traffic`` and
  ``test_multi_model_tenancy_isolation`` fail; the port's plain version
  shows no such drift;
* ``load_centroids`` reads checkpoints written by either package, engine
  (7 leaves), legacy (6 leaves) and batched, to the reference's result.

The port's own bitwise properties (its oracle: ``ref.assign_ref`` on the
request alone, at ``MIN_ROWS`` rows or more): coalesced equals per-request across every bucket
boundary under f32, bf16 and bf16x3 (under int8 the per-feature scales are
taken over the whole padded launch, as in the reference, so a response
depends on its neighbours); never split; no plan built after warmup or on
a swap; under concurrent traffic and a hot swap every response is the
oracle on the centroids of the generation it names; tenants are isolated;
``QueueFull`` at once; a closed server drains.

Departure, stated: under ``faults.kernel_failure("assign")`` warmup
raises and nothing is registered (the reference demotes the shape:
``test_warm_assign_demotes_serving_shape``,
``test_server_warmup_demotes_failing_pallas_end_to_end``).
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.cluster import checkpoint as jcheckpoint
from repro.core import bigmeans as jbigmeans
from repro_torch import api
from repro_torch.cluster import checkpoint
from repro_torch.core import bigmeans
from repro_torch.engine import faults
from repro_torch.kernels import ops, ref
from repro_torch.serve import (
    CheckpointWatcher,
    ModelRegistry,
    QueueFull,
    ServeConfig,
    ServerClosed,
    load_centroids,
    serve,
    swap_from_checkpoint,
)

RTOL = 1e-5        # the reference's padded launch vs its oracle (above)
# PyTorch's f32 matmul on the CPU takes another path below 8 rows, whose
# last bits can differ (e.g. k = 7, n = 5); from 8 rows on, a row's result
# depends neither on the row count nor on its place.  Serving launches at
# least ``min_bucket`` rows, so the oracle runs at 8 rows or more.
MIN_ROWS = 8
POLICIES = ("f32", "int8", "bf16", "bf16x3")


def _centroids(k: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 3.0


def _points(m: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _oracle(points, centroids, precision="f32"):
    """The port's plain assign on the request alone, zero-padded to
    ``MIN_ROWS`` rows when it has fewer.  Zero rows change no int8 scale
    (a per-feature max of |x|)."""
    x = np.zeros((max(len(points), MIN_ROWS), points.shape[1]), np.float32)
    x[:len(points)] = points
    ids, d = ref.assign_ref(torch.from_numpy(x), torch.from_numpy(centroids),
                            precision=precision)
    return ids.numpy()[:len(points)], d.numpy()[:len(points)]


def _quick(**overrides) -> dict:
    base = dict(min_bucket=8, max_batch=64, max_linger_ms=2.0,
                queue_depth=64)
    base.update(overrides)
    return base


def _quick_cfg(**overrides) -> ServeConfig:
    return ServeConfig(**_quick(**overrides))


def _serve(models, cfg=None, **overrides):
    return serve(models, cfg or _quick_cfg(), device="cpu", **overrides)


def _reference_serial(C, reqs, **overrides):
    """The reference server's responses, one request per launch (warmup
    off: only the buckets hit are compiled)."""
    cfg = jserve.ServeConfig(**_quick(max_linger_ms=0.0, warmup=False,
                                      **overrides))
    with jserve.serve({"m": C}, cfg) as srv:
        return [srv.assign("m", p) for p in reqs]


def _same_as_reference(got, want):
    assert np.array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=RTOL, atol=0)
    assert (got.version, got.step, got.batch_rows) == \
        (want.version, want.step, want.batch_rows)


# ---------------------------------------------------------------------------
# config contract


CONFIG_CASES = [
    dict(), dict(min_bucket=8, max_batch=64), dict(min_bucket=6, max_batch=48),
    dict(max_batch=100, min_bucket=3), dict(max_batch=0),
    dict(min_bucket=128, max_batch=64), dict(max_linger_ms=-1.0),
    dict(queue_depth=0), dict(poll_interval_s=0.0),
    dict(default_deadline_ms=0.0), dict(validate_requests=1),
    dict(tenant_quota=0), dict(launch_retries=-1), dict(demote_after=True),
    dict(breaker_threshold=-2), dict(breaker_backoff_s=0.0),
    dict(seed=1.5), dict(watcher_timeout_s=0.0), dict(precision="f64"),
    dict(precision="bf16x3"), dict(donate="maybe"), dict(donate="on"),
    dict(warmup=0), dict(impl="nope"), dict(impl="ref"),
]


@pytest.mark.parametrize("knobs", CONFIG_CASES, ids=lambda k: str(k))
def test_config_validation_matches_reference(knobs):
    """The same knobs pass or fail, with the same messages (``impl`` is
    checked against each package's own impls), and the same buckets."""
    def outcome(cls):
        try:
            cfg = cls(**knobs)
        except ValueError as exc:
            return "raises", str(exc).split("; known")[0]
        return "ok", cfg.buckets()

    assert outcome(ServeConfig) == outcome(jserve.ServeConfig)
    if knobs.get("impl") == "nope":
        with pytest.raises(ValueError, match=r"'cuda', 'ref', 'ref_chunked'"):
            ServeConfig(**knobs)
    assert ServeConfig(min_bucket=6, max_batch=48).buckets() == \
        (8, 16, 32, 64)


def test_submit_validation():
    C = _centroids(5, 4)
    with _serve({"m": C}) as srv:
        with pytest.raises(ValueError):          # wrong feature count
            srv.assign("m", _points(3, 7, 0))
        with pytest.raises(ValueError):          # oversized request
            srv.assign("m", _points(65, 4, 0))
        with pytest.raises(ValueError):          # empty request
            srv.assign("m", np.zeros((0, 4), np.float32))
        with pytest.raises(KeyError):
            srv.assign("ghost", _points(3, 4, 0))
        # a 1-D query is promoted to one row; a tensor is taken as it is
        resp = srv.assign("m", _points(1, 4, 0)[0])
        assert resp.ids.shape == (1,) and resp.ids.dtype == np.int32
        resp = srv.assign("m", torch.from_numpy(_points(2, 4, 0)))
        assert resp.dists.shape == (2,) and resp.dists.dtype == np.float32


def test_serve_runs_on_the_card_unless_asked(monkeypatch):
    """``serve()`` and ``Server()`` default to the card and raise without
    one; ``repro_torch.api`` exports the subsystem as the reference's api
    does."""
    assert api.serve is serve and api.ServeConfig is ServeConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve({"m": _centroids(3, 2)}, _quick_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Server(_quick_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry()


# ---------------------------------------------------------------------------
# coalescing correctness


SIZES = [3, 8, 9, 16, 5, 1, 31, 64]              # crosses 8/16/32/64


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x3"])
def test_coalesced_bitwise_equal_per_request_across_buckets(precision):
    """Concurrent (coalesced) and serial (one-per-launch) serving return
    bitwise-identical ids AND distances, each bitwise the oracle on the
    request alone, for request sizes straddling every bucket
    boundary; the serial responses equal the reference server's."""
    C = _centroids(10, 12)
    reqs = [_points(m, 12, seed=100 + i) for i, m in enumerate(SIZES)]
    cfg = _quick_cfg(precision=precision)

    with _serve({"m": C}, cfg.replace(max_linger_ms=0.0)) as srv:
        serial = [srv.assign("m", p) for p in reqs]
    assert all(r.n_coalesced == 1 for r in serial)

    with _serve({"m": C}, cfg.replace(max_linger_ms=100.0)) as srv:
        futures = [srv.submit("m", p) for p in reqs]
        coalesced = [f.result(timeout=30) for f in futures]
    assert any(r.n_coalesced > 1 for r in coalesced), \
        "expected at least one coalesced launch"

    for p, rs, rc in zip(reqs, serial, coalesced):
        oid, od = _oracle(p, C, precision)
        for r in (rs, rc):
            assert np.array_equal(r.ids, oid)
            assert np.array_equal(r.dists, od)
    if precision == "f32":
        for got, want in zip(serial, _reference_serial(C, reqs)):
            _same_as_reference(got, want)


@pytest.mark.parametrize("precision", POLICIES)
def test_each_policy_serves_the_reference_responses(precision):
    """Under every policy one request per launch gives the reference
    server's ids (distances within ``RTOL``), bitwise the oracle on the
    request alone (under int8 too: the padding's zero rows change no
    scale)."""
    C = _centroids(10, 12, seed=3)
    reqs = [_points(m, 12, seed=40 + m) for m in (3, 5, 8)]
    with _serve({"m": C}, _quick_cfg(max_linger_ms=0.0,
                                     precision=precision)) as srv:
        got = [srv.assign("m", p) for p in reqs]
    for r, want in zip(got, _reference_serial(C, reqs, precision=precision)):
        _same_as_reference(r, want)
    for p, r in zip(reqs, got):
        oid, od = _oracle(p, C, precision)
        assert np.array_equal(r.ids, oid) and np.array_equal(r.dists, od)


def _coalesced(srv, reqs):
    """Serve ``reqs[1:]`` in one launch: submitted while a gated launch
    holds the worker (``reqs[0]`` rides that launch alone, once its
    linger has run out)."""
    entry = srv.registry.get("m")
    gate, original = threading.Event(), entry.launch

    def gated(q, snap):
        gate.wait(10.0)
        return original(q, snap)

    entry.launch = gated
    first = srv.submit("m", reqs[0])
    time.sleep(0.15)
    futs = [srv.submit("m", p) for p in reqs[1:]]
    gate.set()
    out = [first.result(timeout=30)] + [f.result(timeout=30) for f in futs]
    entry.launch = original
    return out


def test_int8_scales_span_the_coalesced_launch_as_in_the_reference():
    """Under int8 the per-feature scales are taken over the whole padded
    launch, in the port as in the reference: a request coalesced with a
    wide-ranged neighbour gets the oracle on the packed launch, not its
    own, and the reference's server gives the same ids."""
    C = _centroids(10, 12, seed=4)
    small = _points(6, 12, seed=1) * 0.1
    reqs = [_points(3, 12, seed=0), small, _points(5, 12, seed=2) * 30.0]
    cfg = _quick(max_linger_ms=100.0, precision="int8")
    with _serve({"m": C}, ServeConfig(**cfg)) as srv:
        got = _coalesced(srv, reqs)
    with jserve.serve({"m": C}, jserve.ServeConfig(**cfg,
                                                   warmup=False)) as jsrv:
        want = _coalesced(jsrv, reqs)
    assert [r.n_coalesced for r in got] == [1, 2, 2]
    packed = np.concatenate(reqs[1:])
    ids, d = _oracle(packed, C, "int8")
    assert np.array_equal(got[1].ids, ids[:6])
    assert np.array_equal(got[1].dists, d[:6])
    alone_ids, alone_d = _oracle(small, C, "int8")
    assert not np.array_equal(got[1].dists, alone_d)
    for r, w in zip(got, want):
        assert r.n_coalesced == w.n_coalesced
        assert np.array_equal(r.ids, w.ids)
        np.testing.assert_allclose(r.dists, w.dists, rtol=RTOL, atol=0)


def test_requests_never_split_across_launches():
    """A request's rows always come from exactly one launch (and one
    snapshot): coalescing stops before max_batch would be exceeded."""
    C = _centroids(6, 4)
    with _serve({"m": C}, _quick_cfg(max_batch=32,
                                     max_linger_ms=100.0)) as srv:
        futures = [srv.submit("m", _points(20, 4, seed=i)) for i in range(3)]
        resps = [f.result(timeout=30) for f in futures]
        assert srv.stats("m")["replays"] == {32: 3}
    for r in resps:
        assert r.batch_rows <= 32
    assert all(r.n_coalesced == 1 for r in resps)


@pytest.mark.parametrize("donate", ["on", "off", "auto"])
def test_donate_changes_nothing(donate):
    """``donate`` is accepted and validated as in the reference; every
    mode serves the same bits."""
    C = _centroids(7, 5, seed=2)
    reqs = [_points(m, 5, seed=m) for m in (2, 9, 17)]
    with _serve({"m": C}, _quick_cfg(donate=donate)) as srv:
        for p in reqs:
            r = srv.assign("m", p)
            oid, od = _oracle(p, C)
            assert np.array_equal(r.ids, oid) and np.array_equal(r.dists, od)


# ---------------------------------------------------------------------------
# plans: the recompile counter


def test_zero_plans_after_bucket_warmup_and_swaps():
    C = _centroids(10, 12)
    cfg = _quick_cfg()
    with _serve({"m": C}, cfg) as srv:
        warm = srv.recompiles("m")
        assert warm == len(cfg.buckets())        # one plan per bucket
        for i, m in enumerate([1, 2, 3, 5, 7, 8, 9, 15, 33, 64, 40, 12]):
            srv.assign("m", _points(m, 12, seed=i))
        futures = [srv.submit("m", _points(m, 12, seed=50 + m))
                   for m in (4, 6, 10, 14, 22)]
        for f in futures:
            f.result(timeout=30)
        for i in range(3):
            srv.swap("m", _centroids(10, 12, seed=i + 10))
            srv.assign("m", _points(3, 12, seed=i))
        assert srv.recompiles("m") == warm, "a plan was built after warmup"
        assert srv.stats("m")["recompiles"] == warm


def test_plans_built_at_first_use_without_warmup():
    """With ``warmup=False`` each bucket's plan is built at its first
    launch, once (the reference traces there)."""
    C = _centroids(5, 4)
    with _serve({"m": C}, _quick_cfg(warmup=False)) as srv:
        assert srv.recompiles("m") == 0
        srv.assign("m", _points(3, 4, 0))
        srv.assign("m", _points(5, 4, 1))
        assert srv.recompiles("m") == 1
        srv.assign("m", _points(20, 4, 2))
        assert srv.recompiles("m") == 2


# ---------------------------------------------------------------------------
# hot-swap


def test_hot_swap_under_concurrent_traffic():
    """Swap mid-traffic: every request completes, each response is bitwise
    the oracle on the centroids of the generation it names, and both
    generations are observed."""
    k, n = 8, 6
    C0 = _centroids(k, n, seed=1)
    C1 = C0[np.roll(np.arange(k), 1)]            # every id changes
    gens = [C0, C1]
    results, errors = [], []
    lock = threading.Lock()

    with _serve({"m": C0}, _quick_cfg(max_linger_ms=1.0,
                                      queue_depth=512)) as srv:
        stop = threading.Event()

        def client(cid: int):
            i = 0
            while not stop.is_set():
                p = _points(5 + (i % 11), n, seed=cid * 1000 + i)
                try:
                    r = srv.submit("m", p).result(timeout=30)
                except Exception as exc:          # pragma: no cover
                    with lock:
                        errors.append(exc)
                    return
                with lock:
                    results.append((p, r))
                i += 1

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()

        def wait_for(count):
            t0 = time.monotonic()
            while time.monotonic() - t0 < 30:
                with lock:
                    if len(results) >= count:
                        return
                time.sleep(0.005)

        wait_for(20)
        srv.swap("m", C1, step=123)
        wait_for(len(results) + 20)
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert not errors
        assert ("swap", "m", 123) in srv.trace
        assert srv.recompiles("m") == len(_quick_cfg().buckets())

    assert {r.version for _, r in results} == {0, 1}
    for p, r in results:
        oid, od = _oracle(p, gens[r.version])
        assert np.array_equal(r.ids, oid), \
            "response mixed centroid generations"
        assert np.array_equal(r.dists, od)
        assert r.step == (123 if r.version else None)


def test_swap_shape_mismatch_rejected():
    C = _centroids(5, 4)
    with _serve({"m": C}) as srv:
        with pytest.raises(ValueError):
            srv.swap("m", _centroids(6, 4))
        with pytest.raises(ValueError):
            srv.swap("m", np.full((5, 4), np.nan, np.float32))
        with pytest.raises(ValueError):
            srv.swap("m", np.zeros(4, np.float32))
        assert srv.stats("m")["version"] == 0    # nothing swapped


def test_snapshot_is_a_copy():
    """The served centroids are the registry's own: changing the array
    registered (or swapped in) afterwards changes nothing."""
    C = _centroids(5, 4)
    p = _points(6, 4, 3)
    with _serve({"m": C.copy()}) as srv:
        C_live = srv.registry.get("m").snapshot().centroids
        assert C_live.dtype == torch.float32 and C_live.device.type == "cpu"
        before = srv.assign("m", p)
        C1 = _centroids(5, 4, seed=9)
        srv.swap("m", C1)
        C1[:] = 0.0
        after = srv.assign("m", p)
    assert np.array_equal(before.ids, _oracle(p, C)[0])
    assert np.array_equal(after.ids, _oracle(p, _centroids(5, 4, seed=9))[0])


# ---------------------------------------------------------------------------
# tenancy


def test_multi_model_tenancy_isolation():
    """Two resident (k, n) models serve interleaved concurrent traffic;
    each response is bitwise the oracle of its own model, its ids the
    reference server's, and the per-model accounting never bleeds across
    tenants."""
    Ca = _centroids(7, 5, seed=1)
    Cb = _centroids(13, 5, seed=2)
    reqs = [("a" if i % 2 == 0 else "b", _points(4 + (i % 9), 5, seed=i))
            for i in range(30)]
    with _serve({"a": Ca, "b": Cb}, _quick_cfg(max_linger_ms=1.0)) as srv:
        futures = [(mid, p, srv.submit(mid, p)) for mid, p in reqs]
        got = []
        for mid, p, f in futures:
            r = f.result(timeout=30)
            assert r.model_id == mid
            oid, od = _oracle(p, Ca if mid == "a" else Cb)
            assert np.array_equal(r.ids, oid)
            assert np.array_equal(r.dists, od)
            assert r.ids.max() < (7 if mid == "a" else 13)
            got.append(r)
        stats = srv.stats()
        assert stats["a"]["n_requests"] == 15
        assert stats["b"]["n_requests"] == 15
        assert stats["a"]["k"] == 7 and stats["b"]["k"] == 13
        srv.swap("a", _centroids(7, 5, seed=9))
        assert srv.stats("a")["version"] == 1
        assert srv.stats("b")["version"] == 0
    cfg = jserve.ServeConfig(**_quick(max_linger_ms=1.0, warmup=False))
    with jserve.serve({"a": Ca, "b": Cb}, cfg) as jsrv:
        want = [jsrv.assign(mid, p) for mid, p in reqs]
    for r, w in zip(got, want):
        assert np.array_equal(r.ids, w.ids)
        np.testing.assert_allclose(r.dists, w.dists, rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# admission control


def test_queue_full_rejects_immediately_not_a_hang():
    C = _centroids(5, 4)
    with _serve({"m": C}, _quick_cfg(queue_depth=4, max_linger_ms=0.0)) \
            as srv:
        entry = srv.registry.get("m")
        in_launch = threading.Event()
        release = threading.Event()
        orig = entry.launch

        def slow_launch(q, snap):
            in_launch.set()
            release.wait(timeout=30)
            return orig(q, snap)

        entry.launch = slow_launch
        try:
            first = srv.submit("m", _points(2, 4, 0))
            assert in_launch.wait(timeout=10)
            queued = [srv.submit("m", _points(2, 4, i + 1)) for i in range(4)]
            t0 = time.monotonic()
            with pytest.raises(QueueFull):
                srv.submit("m", _points(2, 4, 99))
            assert time.monotonic() - t0 < 1.0, "rejection must not block"
            assert srv.stats("m")["n_rejected"] == 1
        finally:
            release.set()
            entry.launch = orig
        for f in [first] + queued:
            f.result(timeout=30)
        retry = srv.assign("m", _points(2, 4, 99))
        assert np.array_equal(retry.ids, _oracle(_points(2, 4, 99), C)[0])


def test_closed_server_rejects_and_drains():
    C = _centroids(5, 4)
    srv = _serve({"m": C})
    f = srv.submit("m", _points(3, 4, 0))
    srv.close()                                   # drains pending work
    assert f.result(timeout=30).ids.shape == (3,)
    with pytest.raises(ServerClosed):
        srv.submit("m", _points(3, 4, 1))


# ---------------------------------------------------------------------------
# checkpoints: load_centroids, swap_from_checkpoint, the watcher


def _state(port: bool, centroids, f_best):
    k, n = centroids.shape[-2:]
    if port:
        return bigmeans.init_state(k, n, device="cpu")._replace(
            centroids=torch.from_numpy(centroids),
            f_best=torch.tensor(f_best, dtype=torch.float32))
    return jbigmeans.init_state(k, n)._replace(
        centroids=jnp.asarray(centroids),
        f_best=jnp.asarray(f_best, jnp.float32))


def _save(writer: str, directory: str, step: int, centroids, *,
          layout: str = "engine", f_best=1.0):
    """A checkpoint written by ``writer``'s package, in the engine's
    ``((state, key), aux)`` layout or the legacy ``(state, key)`` one."""
    port = writer == "port"
    key = np.zeros(2, np.uint32) if port else jnp.zeros(2, jnp.uint32)
    tree = (_state(port, centroids, f_best), key)
    if layout == "engine":
        tree = (tree, np.zeros(3, np.int64))
    (checkpoint if port else jcheckpoint).save(directory, step, tree)


@pytest.mark.parametrize("layout", ["engine", "legacy"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_load_centroids_matches_reference(tmp_path, writer, layout):
    """Each package's checkpoints, both payloads: the verified load, the
    fall back past a torn newest step and the best finite stream of a
    batched state, equal to ``repro.serve.swap.load_centroids``."""
    d = str(tmp_path / "ckpt")
    C5, C9 = _centroids(4, 3, seed=5), _centroids(4, 3, seed=9)
    _save(writer, d, 5, C5, layout=layout)

    def both():
        got, want = load_centroids(d), jserve.load_centroids(d)
        assert got[1] == want[1] and got[0].dtype == np.float32
        assert np.array_equal(got[0], want[0])
        return got

    got, step = both()
    assert step == 5 and np.array_equal(got, C5)
    _save(writer, d, 9, C9, layout=layout)
    assert both()[1] == 9
    faults.corrupt_checkpoint(d)                  # newest step torn
    got, step = both()
    assert step == 5 and np.array_equal(got, C5)

    Cs = np.stack([_centroids(4, 3, seed=20 + b) for b in range(3)])
    d2 = str(tmp_path / "ckpt_b")
    _save(writer, d2, 1, Cs, layout=layout,
          f_best=np.asarray([np.inf, 2.0, 5.0], np.float32))
    got, want = load_centroids(d2), jserve.load_centroids(d2)
    assert np.array_equal(got[0], Cs[1]) and np.array_equal(got[0], want[0])


def test_load_centroids_refuses_what_the_reference_refuses(tmp_path):
    d = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_centroids(d)
    _save("port", d, 3, _centroids(4, 3))
    faults.corrupt_checkpoint(d)
    with pytest.raises(ValueError, match="fails verification"):
        load_centroids(d, step=3)
    d2 = str(tmp_path / "odd")
    checkpoint.save(d2, 1, (np.zeros(3), np.zeros(2)))
    with pytest.raises(ValueError, match="unrecognized checkpoint payload"):
        load_centroids(d2)


def test_swap_from_checkpoint_records_step(tmp_path):
    d = str(tmp_path / "ckpt")
    C = _centroids(6, 4, seed=3)
    _save("reference", d, 7, C)
    reg = ModelRegistry(device="cpu")
    reg.register("m", _centroids(6, 4, seed=0))
    snap = swap_from_checkpoint(reg, "m", d)
    assert snap.step == 7 and snap.version == 1
    assert ("swap", "m", 7) in reg.trace
    assert np.array_equal(snap.centroids.numpy(), C)


def test_checkpoint_watcher_swaps_under_traffic(tmp_path):
    d = str(tmp_path / "ckpt")
    C0 = _centroids(5, 4, seed=0)
    C1 = _centroids(5, 4, seed=1)
    _save("port", d, 1, C0)
    with _serve({"m": C0}) as srv:
        watcher = srv.watch("m", d, poll_interval_s=0.02)
        assert isinstance(watcher, CheckpointWatcher)
        time.sleep(0.1)
        assert watcher.n_swaps <= 1               # step 1 may apply once
        base = srv.stats("m")["version"]
        _save("port", d, 2, C1)                   # "training" publishes
        deadline = time.monotonic() + 10
        while srv.stats("m")["version"] == base:
            srv.assign("m", _points(3, 4, 0))     # traffic keeps flowing
            if time.monotonic() > deadline:
                pytest.fail("watcher never swapped the new checkpoint")
            time.sleep(0.02)
        assert watcher.last_step == 2
        r = srv.assign("m", _points(3, 4, 1))
        assert r.step == 2
        assert np.array_equal(r.ids, _oracle(_points(3, 4, 1), C1)[0])
        assert srv.recompiles("m") == len(_quick_cfg().buckets())


# ---------------------------------------------------------------------------
# warmup: ops.warm_assign, and the raise that replaces demotion


def test_warm_assign_healthy_path():
    assert ops.warm_assign(16, 8, 4, impl="ref", device="cpu") == "ref"
    assert ops.warm_assign(16, 8, 4, device="cpu",
                           precision="int8") == "ref"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.warm_assign(16, 8, 4, impl="cuda", device="cpu")


@pytest.fixture
def kernel_table(monkeypatch):
    """Dispatch the CPU tensors of these tests through the kernel table
    (``impl="cuda"`` resolved as on the card), so that warmup reaches the
    wrappers that ``faults.kernel_failure`` replaces."""
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
    monkeypatch.setattr(ops, "tune_backend", lambda device: "cuda-sm_90")


@pytest.mark.parametrize("precision", POLICIES)
def test_warm_assign_raises_under_kernel_failure(kernel_table, precision):
    """Mirrors ``test_warm_assign_demotes_serving_shape`` with the stated
    departure: the failing kernel raises at warmup, under every policy."""
    with faults.kernel_failure("assign"):
        with pytest.raises(RuntimeError,
                           match="injected assign kernel failure"):
            ops.warm_assign(32, 256, 16, precision=precision, device="cpu")


def test_server_warmup_raises_and_registers_nothing(kernel_table):
    """Mirrors ``test_server_warmup_demotes_failing_pallas_end_to_end``
    with the stated departure: ``serve()`` raises the kernel's error, and
    neither a server nor its registry keeps the model."""
    C = _centroids(10, 12)
    with faults.kernel_failure("assign"):
        with pytest.raises(RuntimeError,
                           match="injected assign kernel failure"):
            _serve({"m": C})
        srv = api.Server(_quick_cfg(), device="cpu")
        with pytest.raises(RuntimeError,
                           match="injected assign kernel failure"):
            srv.register("m", C)
    assert srv.models() == [] and srv.health()["models"] == {}
    with pytest.raises(KeyError):
        srv.submit("m", _points(3, 12, 0))
    srv.close()
