"""The streaming strategy: the port's ``fit(method="streaming")`` and
``run_stream`` against the reference's ``repro.api.fit(method="streaming",
impl="ref")`` and ``repro.engine.stream.run_stream``.

The quick-tier datasets of the reference's evalsuite (``road3d-24k``: n=3,
``hepmass-16k``: n=28, both k=15, s=2048, 24 chunks) are built in numpy and
handed to both packages, which draw the same chunks (NumPy
``default_rng((seed, chunk_id))``).  The port runs on the CPU with the
jax-replay key tree, whose ``fold_in`` gives the reference's per-chunk
keys, so it must take every decision the reference takes: the same accepts,
Lloyd iterations, chunk ids and trace events, in fold mode (``sync_every=1``)
and persistent mode (``batch=4, sync_every=2``).  Objectives, centroids,
``n_d`` and the trace's floats differ only by summation order (``RTOL``).
"""
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.data.synthetic import gmm_dataset
from repro.engine import stream as jstream
from repro.evalsuite.datasets import get_dataset
from repro_torch import api
from repro_torch.engine import faults, stream
from repro_torch.engine import middleware as mw
from test_torch_rng import REPLAY

RTOL = 1e-5

MODES = {"fold-b1": dict(), "fold-b4": dict(batch=4, sync_every=1),
         "persistent-b4": dict(batch=4, sync_every=2)}
CASES = ([(d, mode, "f32") for d in ("road3d-24k", "hepmass-16k")
          for mode in MODES]
         + [("hepmass-16k", "fold-b1", p) for p in ("int8", "bf16", "bf16x3")])

_DATA: dict = {}


def dataset(name):
    if name not in _DATA:
        spec = get_dataset(name)
        _DATA[name] = spec, np.asarray(gmm_dataset(spec.gmm))
    return _DATA[name]


def assert_same_trace(got, want):
    """Equal chunk ids and events; progress floats within RTOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w[0], str):
            assert g == w
        else:
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1:], w[1:], rtol=RTOL)


def assert_same_fit(got, want):
    assert got.strategy == want.strategy == "streaming"
    assert got.n_chunks == want.n_chunks
    assert got.n_accepted == want.n_accepted
    assert got.n_iterations == want.n_iterations
    assert_same_trace(got.trace, want.trace)
    for key in ("chunks_failed", "chunks_dropped", "chunks_quarantined"):
        assert got.extras[key] == want.extras[key], key
    np.testing.assert_allclose(got.objective, want.objective, rtol=RTOL)
    np.testing.assert_allclose(got.n_dist_evals, want.n_dist_evals,
                               rtol=RTOL)
    ref_c = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), ref_c, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref_c).max()))


@pytest.mark.parametrize("name,mode,precision", CASES,
                         ids=["-".join(c) for c in CASES])
def test_streaming_fit_matches_reference(name, mode, precision):
    spec, X = dataset(name)
    cfg = dict(k=spec.k, s=spec.s, n_chunks=spec.n_chunks, log_every=1,
               precision=precision, **MODES[mode])
    want = japi.fit(X, japi.BigMeansConfig(**cfg), method="streaming",
                    impl="ref")
    got = api.fit(X, api.BigMeansConfig(**cfg), method="streaming",
                  device="cpu", rng=REPLAY)
    assert_same_fit(got, want)
    assert got.extras["health"]["chunks_fetched"] == spec.n_chunks
    assert got.extras["fit"]["precision"] == precision
    assert len(got.extras["pipeline"]["fetch_ms"]) == spec.n_chunks
    assert got.extras["pipeline"]["copy_ms"] == []         # no copy stream


def test_adapters_serve_the_reference_chunks(tmp_path):
    """Every adapter's chunks are byte for byte the reference adapter's for
    the same (seed, chunk_id), with and without replacement."""
    X = np.random.default_rng(0).normal(size=(3000, 6)).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, X)
    for replace in (True, False):
        pairs = [(api.ArraySource(X), japi.ArraySource(X)),
                 (api.ArraySource(torch.from_numpy(X)), japi.ArraySource(X)),
                 (api.MemmapSource(path), japi.MemmapSource(path))]
        for port, ref in pairs:
            pf = port.provider(256, seed=9, with_replacement=replace)
            rf = ref.provider(256, seed=9, with_replacement=replace)
            for cid in (0, 1, 17, 2**20):
                a, b = pf(cid), rf(cid)
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    chunks = [X[i * 100:(i + 1) * 100] for i in range(5)]
    for port, ref in [(api.ProviderSource(lambda c: chunks[c]),
                       japi.ProviderSource(lambda c: chunks[c])),
                      (api.IteratorSource(iter(chunks)),
                       japi.IteratorSource(iter(chunks)))]:
        assert port.n_features == ref.n_features == 6
        pf, rf = port.provider(100), ref.provider(100)
        for cid in (0, 2, 1, 3, 4):             # out of order: reorder cache
            assert pf(cid).tobytes() == rf(cid).tobytes()


def test_all_sources_fit_the_same(tmp_path):
    """fit over an .npy path ('auto' picks streaming), an array, a provider
    and an iterator of the same chunks: the same run, bit for bit."""
    spec, X = dataset("road3d-24k")
    path = tmp_path / "x.npy"
    np.save(path, X)
    cfg = api.BigMeansConfig(k=spec.k, s=spec.s, n_chunks=8, log_every=1)
    base = api.fit(str(path), cfg, device="cpu")
    assert base.strategy == "streaming" and base.extras["auto"]
    assert base.extras["fit"]["source"] == "MemmapSource"
    fetch = api.MemmapSource(path).provider(cfg.s, seed=cfg.seed)
    others = [api.fit(X, cfg, method="streaming", device="cpu"),
              api.fit(fetch, cfg, device="cpu"),
              api.fit((fetch(c) for c in range(cfg.n_chunks)), cfg,
                      device="cpu", n_features=3)]
    assert [r.strategy for r in others] == ["streaming"] * 3
    for r in others:
        assert torch.equal(r.centroids, base.centroids)
        assert r.trace == base.trace and r.objective == base.objective


def test_streaming_from_path_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "x.npy"
    np.save(path, np.zeros((100, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.fit(str(path), api.BigMeansConfig(k=3, s=50, n_chunks=2))


# ---------------------------------------------------------------------------
# the host runner (tests/test_batched.py:232-255, tests/test_engine.py)
# ---------------------------------------------------------------------------


def mixture_provider(s=512, n=8, seed=3):
    """chunk_id -> [s, n] from a fixed 5-component mixture (numpy)."""
    means = np.random.default_rng(seed).normal(size=(5, n)) * 5

    def provider(cid):
        rng = np.random.default_rng((seed, cid))
        comp = rng.integers(0, 5, size=s)
        return (means[comp] + rng.normal(size=(s, n))).astype(np.float32)

    return provider


def run_both(cfg_kw, provider, **kw):
    jstate, jm = jstream.run_stream(
        provider, japi.BigMeansConfig(impl="ref", **cfg_kw), n_features=8,
        **kw)
    state, m = stream.run_stream(
        provider, api.BigMeansConfig(**cfg_kw), n_features=8, rng=REPLAY,
        key=REPLAY.key(cfg_kw.get("seed", 0)), device="cpu", **kw)
    for f in ("chunks_done", "chunks_failed", "chunks_dropped",
              "chunks_quarantined", "accepted", "lloyd_iters"):
        assert getattr(m, f) == getattr(jm, f), f
    np.testing.assert_allclose(m.f_best, jm.f_best, rtol=RTOL)
    np.testing.assert_allclose(state.centroids.numpy(),
                               np.asarray(jstate.centroids), rtol=RTOL,
                               atol=RTOL * 20)
    assert_same_trace(m.trace, jm.trace)
    return state, m


def test_runner_batched_end_to_end():
    _, m = run_both(dict(k=5, s=512, n_chunks=12, batch=4, seed=1),
                    mixture_provider())
    assert m.chunks_done == 12 and np.isfinite(m.f_best)


def test_runner_batched_partial_batch_and_failures():
    def bomb(cid):
        if cid in (2, 5):
            raise RuntimeError("node lost")

    _, m = run_both(dict(k=5, s=512, n_chunks=11, batch=4, seed=2),
                    mixture_provider(), fault_injector=bomb)
    assert m.chunks_failed == 2
    assert m.chunks_done == 9          # 2 full batches + partial final batch


@pytest.mark.parametrize("batch,sync_every", [(1, 1), (4, 2)])
def test_runner_prefetch_matches_sync(batch, sync_every):
    """The prefetch thread must not change results: prefetch=3 and
    prefetch=0 are the same run, bit for bit."""
    provider = mixture_provider()
    runs = [stream.run_stream(
        provider, api.BigMeansConfig(k=5, s=512, n_chunks=8, batch=batch,
                                     sync_every=sync_every, prefetch=p,
                                     seed=4, log_every=1),
        n_features=8, device="cpu") for p in (3, 0)]
    (s3, m3), (s0, m0) = runs
    assert torch.equal(s3.centroids, s0.centroids)
    assert m3.trace == m0.trace and m3.f_best == m0.f_best
    assert len(m3.pipeline["wait_ms"]) == 8 and m0.pipeline["wait_ms"] == []


@pytest.mark.parametrize("sync", ["auto", "competitive"])
def test_streaming_persistent_streams_runs(sync):
    """batch > 1 with periodic / competitive sync keeps per-stream
    incumbents across batches, as the reference does."""
    provider = mixture_provider(s=1024)
    cfg = dict(k=5, s=1024, n_chunks=16, batch=4, sync_every=2, seed=1,
               sync=sync, log_every=1)
    want = japi.fit(provider, japi.BigMeansConfig(impl="ref", **cfg),
                    method="streaming", n_features=8)
    got = api.fit(provider, api.BigMeansConfig(**cfg), method="streaming",
                  n_features=8, device="cpu", rng=REPLAY)
    assert got.n_chunks == 16 and np.isfinite(got.objective)
    assert_same_fit(got, want)


def test_streaming_surfaces_lloyd_iterations():
    cfg = api.BigMeansConfig(k=5, s=1024, n_chunks=6, seed=2)
    r = api.fit(mixture_provider(s=1024), cfg, method="streaming",
                n_features=8, device="cpu")
    assert r.n_iterations > 0


# ---------------------------------------------------------------------------
# sources and fetch hygiene (tests/test_api.py)
# ---------------------------------------------------------------------------


def test_provider_and_iterator_sources_round_trip():
    chunks = [np.full((16, 4), float(i), np.float32) for i in range(6)]
    psrc = api.ProviderSource(lambda cid: chunks[cid])
    assert psrc.n_features == 4              # probed from chunk 0
    isrc = api.IteratorSource(iter(chunks), n_features=4)
    pf, itf = psrc.provider(16), isrc.provider(16)
    for cid in range(6):
        np.testing.assert_array_equal(pf(cid), itf(cid))
    assert not psrc.in_core
    with pytest.raises(TypeError, match="streaming"):
        psrc.as_array()
    tsrc = api.ProviderSource(lambda cid: torch.from_numpy(chunks[cid]))
    np.testing.assert_array_equal(tsrc.provider(16)(3), chunks[3])


def test_as_source_dispatch(tmp_path):
    path = tmp_path / "d.npy"
    np.save(path, np.zeros((10, 3), np.float32))
    assert isinstance(api.as_source(np.zeros((4, 2))), api.ArraySource)
    assert isinstance(api.as_source(torch.zeros(4, 2)), api.ArraySource)
    assert isinstance(api.as_source(str(path)), api.MemmapSource)
    assert isinstance(api.as_source(lambda cid: None), api.ProviderSource)
    assert isinstance(api.as_source(iter([])), api.IteratorSource)
    src = api.ArraySource(np.zeros((4, 2)))
    assert api.as_source(src) is src
    with pytest.raises(TypeError):
        api.as_source(object())


def test_in_core_strategy_rejects_stream_source():
    cfg = api.BigMeansConfig(k=5, s=500, n_chunks=8)
    with pytest.raises(TypeError, match="streaming"):
        api.fit(lambda cid: np.zeros((8, 2), np.float32), cfg,
                method="sequential", n_features=2, device="cpu")


def test_streaming_strategy_from_array_source():
    X = mixture_provider(s=6000)(0)
    r = api.fit(X, api.BigMeansConfig(k=5, s=500, n_chunks=8, seed=3),
                method="streaming", device="cpu")
    assert r.centroids.shape == (5, 8) and np.isfinite(r.objective)
    assert r.strategy == "streaming" and r.algorithm == "big_means"
    assert r.n_chunks == 8 and r.config.k == 5


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fetch_failures_recorded_in_trace(prefetch):
    base = mixture_provider(s=256)

    def provider(cid):
        if cid == 2:
            raise RuntimeError("node lost")
        return base(cid)

    r = api.fit(provider, api.BigMeansConfig(k=5, s=256, n_chunks=6, seed=1,
                                             prefetch=prefetch),
                method="streaming", n_features=8, device="cpu")
    assert r.extras["chunks_failed"] == 1
    errors = [t for t in r.trace if t[0] == "fetch_error"]
    assert errors == [("fetch_error", 2, "RuntimeError: node lost")]


def test_iterator_exhaustion_ends_run_cleanly():
    """A finite chunk stream shorter than n_chunks is a clean end of
    stream, not a pile of phantom fetch failures."""
    provider = mixture_provider(s=256)
    chunks = (provider(i) for i in range(5))
    r = api.fit(chunks, api.BigMeansConfig(k=5, s=256, n_chunks=20, seed=0),
                method="streaming", n_features=8, device="cpu")
    assert r.n_chunks == 5
    assert r.extras["chunks_failed"] == 0
    assert not [t for t in r.trace if t[0] == "fetch_error"]


def test_streaming_honors_with_replacement():
    src = api.as_source(np.arange(40, dtype=np.float32).reshape(20, 2))
    chunk = src.provider(10, seed=0, with_replacement=False)(0)
    assert len({tuple(row) for row in chunk}) == 10     # all rows distinct
    cfg = dict(k=3, s=10, n_chunks=4, seed=0, with_replacement=False)
    got = api.fit(src, api.BigMeansConfig(**cfg), method="streaming",
                  device="cpu", rng=REPLAY)
    want = japi.fit(np.asarray(src.X), japi.BigMeansConfig(impl="ref", **cfg),
                    method="streaming")
    assert np.isfinite(got.objective)
    assert_same_fit(got, want)


def test_provider_probe_not_refetched():
    calls = []

    def provider(cid):
        calls.append(cid)
        return np.zeros((16, 4), np.float32) + cid

    src = api.as_source(provider)
    assert src.n_features == 4                   # probes chunk 0
    fetch = src.provider(16)
    np.testing.assert_array_equal(fetch(0), np.zeros((16, 4)))
    fetch(1)
    assert calls == [0, 1]                       # chunk 0 fetched exactly once


# ---------------------------------------------------------------------------
# host staging, faults and health
# ---------------------------------------------------------------------------


def staged(precision, arr):
    st = stream._Stager(torch.device("cpu"), precision,
                        stream.RunnerMetrics().pipeline)
    return st.ship(st.prepare(arr)).take()


def test_int8_staging_is_the_reference_bitwise():
    rng = np.random.default_rng(1)
    arr = (rng.normal(size=(700, 9)) * rng.uniform(0.01, 300, 9)
           ).astype(np.float32)
    arr[:, 4] = 0.0                              # an all-zero feature
    got = staged("int8", arr)
    assert got.dtype == torch.float32
    want = np.asarray(jstream._stage_quantized(arr))
    assert got.numpy().tobytes() == want.tobytes()
    bad = arr.copy()
    bad[5, 2] = np.nan
    got = staged("int8", bad).numpy()            # shipped unquantized
    assert got.tobytes() == bad.tobytes()


def test_bf16_staging_is_the_ml_dtypes_cast():
    """The bf16 host cast (torch, round to nearest even) gives the bits of
    the reference's ml_dtypes cast: random bit patterns, exact ties to
    even and odd, the extremes of the f32 range."""
    import ml_dtypes

    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2**32, size=20_000, dtype=np.uint64)
    arr = bits.astype(np.uint32).view(np.float32)
    arr = arr[np.isfinite(arr)]
    ties = (np.arange(256, dtype=np.uint32) << 16) | 0x8000
    edges = np.array([3.3e38, -3.3e38, 1e-40, -0.0, 0.0, np.inf, -np.inf],
                     np.float32)
    arr = np.concatenate([arr, ties.view(np.float32)[:200], edges])
    arr = arr[: arr.size // 7 * 7].reshape(-1, 7)
    got = staged("bf16", arr)
    assert got.dtype == torch.bfloat16
    want = np.asarray(arr, dtype=ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_streaming_runner_serves_bf16_chunks():
    """tests/test_precision.py:157 on the port: the bf16 run's chunks are
    the ml_dtypes cast, and the run takes the reference's decisions."""
    X = np.random.default_rng(0).normal(size=(20_000, 8)).astype(np.float32)
    cfg = dict(k=5, s=1024, n_chunks=6, precision="bf16", prefetch=2,
               log_every=1)
    got = api.fit(api.as_source(X), api.BigMeansConfig(**cfg),
                  method="streaming", device="cpu", rng=REPLAY)
    want = japi.fit(japi.as_source(X), japi.BigMeansConfig(impl="ref", **cfg),
                    method="streaming")
    assert np.isfinite(got.objective) and got.n_chunks == 6
    assert_same_fit(got, want)


def faulty_provider(s, short_rows):
    """Chunk 1 fails once (transient, retried), chunk 4 always (a permanent
    ValueError), chunk 6 carries a NaN, chunk 9 is short."""
    base = mixture_provider(s=s)
    attempts: dict = {}

    def provider(cid):
        attempts[cid] = attempts.get(cid, 0) + 1
        if cid == 1 and attempts[cid] == 1:
            raise ConnectionError("flaky")
        if cid == 4:
            raise ValueError("malformed record")
        chunk = base(cid)
        if cid == 6:
            chunk[3, 1] = np.nan
        if cid == 9:
            chunk = chunk[:short_rows]
        return chunk

    return provider


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["fold-b1", "persistent-b4"])
def test_health_reconciles_under_faults(mode, precision):
    """done + failed + dropped + quarantined == fetched, with the
    reference's accounting and decisions; a NaN chunk is quarantined
    (under int8 it ships unquantized, so the sanitizer sees it)."""
    cfg = dict(k=5, s=512, n_chunks=12, seed=5, retries=1,
               retry_backoff_s=0.001, log_every=1, precision=precision,
               **MODES[mode])
    want = japi.fit(faulty_provider(512, 300),
                    japi.BigMeansConfig(impl="ref", **cfg),
                    method="streaming", n_features=8)
    got = api.fit(faulty_provider(512, 300), api.BigMeansConfig(**cfg),
                  method="streaming", n_features=8, device="cpu", rng=REPLAY)
    assert_same_fit(got, want)
    health = got.extras["health"]
    assert health["chunks_fetched"] == 12
    assert (health["chunks_done"] + health["chunks_failed"]
            + health["chunks_dropped"] + health["chunks_quarantined"]) == 12
    assert health["chunks_failed"] == 1 and health["chunks_quarantined"] == 1
    assert health["quarantine_reasons"] == [(6, "non-finite values (NaN/Inf)")]
    assert ("fetch_error", 4, "ValueError: malformed record") in got.trace
    dropped = [t for t in got.trace if t[0] == "short_chunk"]
    assert dropped == ([("short_chunk", 9, 300, 512)]
                       if mode.startswith("persistent") else [])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_staging_error_ends_the_run(prefetch, monkeypatch):
    """Only the provider's exceptions are fetch failures: an error while
    staging a chunk onto the device is re-raised and ends the run."""
    def broken(self, prepared):
        raise RuntimeError("device lost")

    monkeypatch.setattr(stream._Stager, "ship", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        api.fit(mixture_provider(), api.BigMeansConfig(
            k=5, s=512, n_chunks=4, prefetch=prefetch),
            n_features=8, device="cpu")


def test_invariant_guard_and_fault_vocabulary():
    with pytest.raises(faults.InvariantViolation):
        guard = mw.InvariantGuard()
        ctx = mw.EngineContext(cfg=None, key=None, metrics=None,
                               extras={"stream_mode": "fold"}, last_s=10)
        for f in (5.0, 9.0):
            ctx.state = type("S", (), {"f_best": torch.tensor(f)})
            guard.after_window(ctx)
    assert faults.classify(faults.FetchTimeout()) == faults.TRANSIENT
    assert faults.classify(KeyError()) == faults.PERMANENT
    assert faults.classify(OSError()) == faults.TRANSIENT
    pol = faults.RetryPolicy(retries=2, seed=3)
    from repro.engine import faults as jfaults

    jpol = jfaults.RetryPolicy(retries=2, seed=3)
    assert [pol.delay(7, a) for a in range(3)] == \
        [jpol.delay(7, a) for a in range(3)]
    with pytest.raises(faults.FetchTimeout):
        faults.call_with_timeout(lambda: __import__("time").sleep(1), 0.01)


def test_loader_and_gmm_memmap_match(tmp_path):
    """MemmapProvider and csv_to_npy are the reference's; gmm_memmap writes
    byte for byte the rows of gmm_dataset (across generation chunks)."""
    from repro.data import loader as jloader
    from repro_torch.data import loader, synthetic

    spec = synthetic.GMMSpec(m=70_000, n=5, components=4, seed=3)
    path = synthetic.gmm_memmap(spec, str(tmp_path / "g.npy"), device="cpu")
    rows = np.load(path)
    assert rows.tobytes() == synthetic.gmm_dataset(
        spec, device="cpu").numpy().tobytes()
    mine, ref = loader.MemmapProvider(path, 300, seed=2), \
        jloader.MemmapProvider(path, 300, seed=2)
    assert mine.shape == ref.shape == (70_000, 5)
    for cid in (0, 5):
        assert mine(cid).tobytes() == ref(cid).tobytes()
    csv = tmp_path / "d.csv"
    csv.write_text("a,b,c\n" + "\n".join(
        ",".join(f"{v:.6g}" for v in row) for row in rows[:50, :3]))
    for fn, out in ((loader.csv_to_npy, "p.npy"),
                    (jloader.csv_to_npy, "r.npy")):
        assert fn(str(csv), str(tmp_path / out), batch_rows=16) == (50, 3)
    assert (tmp_path / "p.npy").read_bytes() == (tmp_path / "r.npy"
                                                 ).read_bytes()
