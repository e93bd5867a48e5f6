"""``repro_torch.tracing``: spans and host-sync counters inside the fit path.

The CPU tests hold what the spans and counters record to what the fit
did; the ``cuda`` test holds the host-sync counters to what
``torch.cuda.set_sync_debug_mode`` reports on the card.  This file imports
neither ``jax`` nor ``repro``, so it runs on a machine that has neither:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_tracing.py
"""
import json
import threading
import warnings

import pytest
import torch

from repro_torch import api, tracing
from repro_torch import random as rnd
from repro_torch.core import bigmeans, kmeanspp
from repro_torch.kernels import ops

SPANS = ("api.fit", "core.bigmeans.sample_chunk", "core.bigmeans.chunk_step",
         "core.kmeanspp.seed", "core.kmeans.lloyd", "core.kmeans.epilogue",
         "api.strategies.result", "api.evaluate")


@pytest.fixture
def traced():
    """Tracing on for the test, off and emptied after it."""
    tracing.snapshot()
    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)
        tracing.snapshot()


def _data(kind: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(5)
    if kind == "blobs":
        centres = 6.0 * torch.randn(8, 6, generator=gen)
        comp = torch.randint(0, 8, (6000,), generator=gen)
        return centres[comp] + torch.randn(6000, 6, generator=gen)
    # 12 distinct rows under k = 16: clusters go empty in every chunk, so
    # every chunk re-seeds
    rows = torch.randn(12, 6, generator=gen)
    return rows[torch.randint(0, 12, (6000,), generator=gen)]


def _cfg(kind: str, **kw) -> api.BigMeansConfig:
    k = 8 if kind == "blobs" else 16
    return api.BigMeansConfig(k=k, s=600, n_chunks=4, seed=11, **kw)


def _seeded(X, cfg) -> tuple[int, int]:
    """(chunks re-seeded, slots seeded) of the sequential fit of ``cfg``,
    replayed chunk by chunk as ``engine.incore.sequential`` runs it."""
    rng = rnd.TORCH
    state = bigmeans.init_state(cfg.k, X.shape[1], device="cpu")
    chunks = slots = 0
    for key_i in rng.split(rng.key(cfg.seed), cfg.n_chunks):
        ks, kc = rng.split(key_i)
        chunk = bigmeans.sample_chunk(X, ks, cfg.s, rng=rng)
        n_deg = int(state.degenerate.sum())
        chunks += n_deg > 0
        slots += n_deg
        state, _ = bigmeans.chunk_step(
            chunk, state, kc, max_iters=cfg.max_iters, tol=cfg.tol,
            candidates=cfg.candidates)
    return chunks, slots


def test_off_span_is_one_shared_noop_that_calls_no_torch_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a torch function was called while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    assert not tracing.enabled()
    first = tracing.span("core.kmeanspp.seed", torch.device("cpu"))
    assert tracing.span("api.fit") is first
    with first as got:
        tracing.count("host_sync.core.kmeans.stop", 5)
    assert got is None
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("kind", ["blobs", "duplicates"])
def test_spans_nest_by_layer_with_a_chunk_step_a_chunk(kind, traced):
    X = _data(kind)
    cfg = _cfg(kind)
    res = api.fit(X, cfg, device="cpu")
    api.evaluate(res, X, device="cpu")
    spans = tracing.snapshot()["spans"]
    assert set(spans) == set(SPANS)
    assert spans["api.fit"]["parents"] == [None]
    assert spans["api.evaluate"]["parents"] == [None]
    for name in ("core.bigmeans.sample_chunk", "core.bigmeans.chunk_step",
                 "api.strategies.result"):
        assert spans[name]["parents"] == ["api.fit"]
    for name in ("core.kmeanspp.seed", "core.kmeans.lloyd",
                 "core.kmeans.epilogue"):
        assert spans[name]["parents"] == ["core.bigmeans.chunk_step"]
    chunks, _ = _seeded(X, cfg)
    assert chunks == (1 if kind == "blobs" else cfg.n_chunks)
    assert spans["core.kmeanspp.seed"]["count"] == chunks
    for name in ("core.bigmeans.sample_chunk", "core.bigmeans.chunk_step",
                 "core.kmeans.lloyd", "core.kmeans.epilogue"):
        assert spans[name]["count"] == res.n_chunks == cfg.n_chunks
    for name in ("api.fit", "api.evaluate", "api.strategies.result"):
        assert spans[name]["count"] == 1
    for s in spans.values():
        assert s["host_ms"] > 0.0
        assert s["device_ms"] is None and s["self_device_ms"] is None
    outer, inner = spans["api.fit"], spans["core.bigmeans.chunk_step"]
    assert outer["host_ms"] >= inner["host_ms"]


@pytest.mark.parametrize("kind", ["blobs", "duplicates"])
def test_counters_agree_with_the_fit_result(kind, traced):
    X = _data(kind)
    cfg = _cfg(kind)
    res = api.fit(X, cfg, device="cpu")
    api.evaluate(res, X, device="cpu")
    counters = tracing.snapshot()["counters"]
    chunks, slots = _seeded(X, cfg)
    assert counters == {
        "host_sync.core.bigmeans.init": 3,
        "host_sync.core.bigmeans.degenerate": res.n_chunks,
        "host_sync.core.kmeanspp.mask": chunks,
        "core.kmeanspp.probe.plain": slots,
        "host_sync.core.kmeans.init": res.n_chunks,
        "host_sync.core.kmeans.stop": res.n_iterations,
        "host_sync.api.result": 5,
        "host_sync.api.evaluate": 1,
    }


@pytest.mark.parametrize("kind", ["blobs", "duplicates"])
def test_batched_counters_agree_with_the_streams(kind, traced):
    X = _data(kind)
    cfg = _cfg(kind, batch=2)
    res = api.fit(X, cfg, method="batched", device="cpu")
    counters = tracing.snapshot()["counters"]
    tracing.enable(False)
    rounds = cfg.n_chunks // cfg.batch
    _, infos = bigmeans.big_means_batched(
        X, rnd.TORCH.key(cfg.seed), k=cfg.k, s=cfg.s, batch=cfg.batch,
        rounds=rounds, sync_every=cfg.sync_every, max_iters=cfg.max_iters,
        tol=cfg.tol, candidates=cfg.candidates, device="cpu")
    iters = infos.lloyd_iters.reshape(rounds, cfg.batch)
    assert int(iters.sum()) == res.n_iterations
    assert counters["host_sync.core.kmeans.stop"] == int(
        (iters.max(dim=1).values + 1).sum())
    assert counters["host_sync.core.bigmeans.batched"] == 3 * rounds
    # two exchanges of the incumbent and the final reduce, 3 reads each
    assert counters["host_sync.core.bigmeans.winner"] == 3 * (rounds + 1)
    assert counters["host_sync.api.result"] == 5
    if kind == "blobs":
        # round 0 seeds both streams from scratch, later rounds none
        assert counters["host_sync.core.kmeanspp.mask"] == 1 + cfg.batch
        assert counters["core.kmeanspp.probe.plain"] == cfg.batch * cfg.k


@pytest.mark.parametrize("case", ["weighted", "bf16"])
def test_seeds_the_slot_kernels_cannot_take_count_as_plain(case, traced,
                                                           monkeypatch):
    """A weighted seeding and a bf16 chunk keep the oracle chain even where
    the slot kernels would run (``resolve_impl`` made to say ``'cuda'``):
    kernel P has no weights operand and would take a bf16 chunk at f32.
    A fresh seeding reads no mask; a re-seeding reads it once."""
    X = _data("blobs")[:600]
    w = torch.rand(600, generator=torch.Generator().manual_seed(1)) + 0.5
    points, weights = (X, w) if case == "weighted" else (X.bfloat16(), None)
    key = rnd.TORCH.key(3)
    want = kmeanspp.seed(points, key, 8, weights=weights)
    deg = torch.tensor([True, False] * 4)
    want2 = kmeanspp.seed(points, key, 8, init=want, degenerate=deg,
                          weights=weights)
    assert tracing.snapshot()["counters"] == {
        "core.kmeanspp.probe.plain": 12,
        "host_sync.core.kmeanspp.mask": 1}
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
    got = kmeanspp.seed(points, key, 8, weights=weights)
    got2 = kmeanspp.seed(points, key, 8, init=got, degenerate=deg,
                         weights=weights)
    assert tracing.snapshot()["counters"] == {
        "core.kmeanspp.probe.plain": 12,
        "host_sync.core.kmeanspp.mask": 1}
    assert torch.equal(got, want) and torch.equal(got2, want2)


@pytest.mark.parametrize("method", ["sequential", "batched"])
def test_results_are_bitwise_the_same_with_tracing_on(method):
    X = _data("duplicates")
    cfg = _cfg("duplicates", batch=2 if method == "batched" else 1)
    off = api.fit(X, cfg, method=method, device="cpu")
    ids_off, f_off = api.evaluate(off, X, device="cpu")
    tracing.enable(True)
    try:
        on = api.fit(X, cfg, method=method, device="cpu")
        ids_on, f_on = api.evaluate(on, X, device="cpu")
    finally:
        tracing.enable(False)
        tracing.snapshot()
    assert torch.equal(off.centroids, on.centroids)
    assert off.objective == on.objective and off.trace == on.trace
    assert off.n_iterations == on.n_iterations
    assert torch.equal(ids_off, ids_on) and f_off == f_on


def test_a_profiler_sees_every_span_with_tracing_off(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    X = _data("blobs")
    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = api.fit(X, _cfg("blobs"), device="cpu")
        api.evaluate(res, X, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(SPANS) <= names
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_each_thread_nests_its_own_spans(traced):
    with tracing.span("outer"):
        t = threading.Thread(target=lambda: tracing.span("other").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with tracing.span("inner"):
            pass
    spans = tracing.snapshot()["spans"]
    assert spans["other"]["parents"] == [None]
    assert spans["inner"]["parents"] == ["outer"]
    assert spans["outer"]["parents"] == [None]
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# Where the host waits for the card without the sync-debug mode's warning:
# api.fit's closing torch.cuda.synchronize() (a device synchronize, which
# the mode does not report).
UNREPORTED = ("host_sync.api.fit",)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(25, 28), (1030, 64)],
                         ids=["fused", "two_pass"])
def test_counted_syncs_are_the_sync_debug_modes_on_card(k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90): the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    X = 5.0 * torch.randn(40_000, n, generator=gen, device="cuda")
    cfg = api.BigMeansConfig(k=k, s=4 * k + 4096, n_chunks=3, seed=7)
    off = api.fit(X, cfg)                  # builds the kernels, warms up
    ids_off, f_off = api.evaluate(off, X)
    torch.cuda.synchronize()
    tracing.snapshot()
    tracing.enable(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                on = api.fit(X, cfg)
                ids_on, f_on = api.evaluate(on, X)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
    reported = [w for w in caught
                if "synchronizing CUDA operation" in str(w.message)]
    counters = snap["counters"]
    counted = sum(v for name, v in counters.items()
                  if name.startswith("host_sync.") and name not in UNREPORTED)
    assert counters["host_sync.api.fit"] == 1
    assert counted == len(reported), (counters, [
        f"{w.filename}:{w.lineno}" for w in reported])
    assert counters["host_sync.core.kmeans.stop"] == on.n_iterations
    for name, s in snap["spans"].items():
        assert s["device_ms"] is not None and s["device_ms"] > 0.0, name
        assert -1e-3 <= s["self_device_ms"] <= s["device_ms"] + 1e-3, name
    assert set(SPANS) <= set(snap["spans"])
    assert torch.equal(off.centroids, on.centroids)
    assert off.objective == on.objective and off.trace == on.trace
    assert torch.equal(ids_off, ids_on) and f_off == f_on
