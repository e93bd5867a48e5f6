"""The port's autotuner (``repro_torch.kernels.autotune``) against the
reference's tuner tests (``tests/test_precision.py``), and the autotuned
``fit`` on the CPU against the untuned one and the reference's.

The tuner's behaviour is the reference's: resolution order, the JSON cache
and its load-anomaly events, the enable scope of ``fit``.  What a
candidate is differs (launch choices that leave every output bitwise
equal, not TPU tilings), and a candidate that raises makes the lookup
raise instead of being skipped.  On the CPU nothing is tuned: the kernels
run only on the card (``test_torch_cuda.py`` holds a tuned launch bitwise
to the untuned one there).
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import bigmeans as jbm
from repro.data.synthetic import gmm_dataset
from repro.evalsuite.datasets import get_dataset
from repro.kernels import autotune as jautotune
from repro_torch import api
from repro_torch.kernels import autotune, fused_step, ops
from test_torch_cuda import blobs
from test_torch_rng import REPLAY

KEY = dict(backend="cuda-sm_90", b=1, m=256, k=25, n=20, precision="f32")


@pytest.fixture
def clean_autotune():
    autotune.clear()
    was_enabled, was_path = autotune.enabled(), autotune.cache_path()
    yield
    autotune.clear()
    autotune.enable(was_enabled)
    autotune.set_cache_path(was_path)


def counting_bench(calls):
    def bench_factory(blocks):
        def run():
            calls.append(dict(blocks))
        return run
    return bench_factory


def test_disabled_returns_defaults(clean_autotune):
    autotune.enable(False)
    calls = []
    for kind, want in (("fused", {"pipeline": "blocks"}),
                       ("assign", {"ctas_per_sm": 2}),
                       ("fused_batched", {})):
        assert autotune.get_blocks(kind, counting_bench(calls), **KEY) == want
    assert calls == []


def test_cache_roundtrip(tmp_path, clean_autotune):
    """Timed once, then served from the file without re-timing."""
    cache = tmp_path / "tune.json"
    autotune.set_cache_path(cache)
    autotune.enable(True)
    calls = []
    kw = dict(KEY, precision="bf16")
    first = autotune.get_blocks("fused", counting_bench(calls), **kw)
    assert cache.exists()
    assert {c["pipeline"] for c in calls} == {"blocks", "dma"}
    assert first in autotune.candidates("fused", **{
        k: v for k, v in kw.items() if k != "backend"})
    timed = [t for t in autotune.timings()
             if t[0] == autotune.cache_key("fused", **kw)]
    assert [t[1] for t in timed] == [{"pipeline": "blocks"},
                                     {"pipeline": "dma"}]

    autotune.clear(disk=False)           # a new process: the file stays
    calls.clear()
    again = autotune.get_blocks("fused", counting_bench(calls), **kw)
    assert again == first
    assert calls == [], "a disk hit must not re-time"
    data = json.loads(cache.read_text())
    assert data["version"] == 1
    assert data["entries"][autotune.cache_key("fused", **kw)] == first


def test_pinned_entry_used_with_tuning_off(tmp_path, clean_autotune):
    """A cached winner is used even when tuning is off: a pinned profile."""
    cache = tmp_path / "pin.json"
    cache.write_text(json.dumps({"version": 1, "entries": {
        autotune.cache_key("fused", **KEY): {"pipeline": "dma"}}}))
    autotune.set_cache_path(cache)
    autotune.enable(False)
    assert autotune.get_blocks("fused", None, **KEY) == {"pipeline": "dma"}


def test_corrupt_cache_ignored_with_event(tmp_path, clean_autotune):
    cache = tmp_path / "tune.json"
    cache.write_text("{this is not json")
    autotune.set_cache_path(cache)
    autotune.enable(True)
    n_events = len(autotune.events())
    assert autotune.get_blocks("fused", None, **KEY) == {"pipeline": "blocks"}
    new = autotune.events()[n_events:]
    assert len(new) == 1
    kind, path, reason = new[0]
    assert kind == "autotune_cache_ignored" and path == str(cache)
    assert reason.startswith("unreadable")


def test_stale_schema_cache_ignored_with_event(tmp_path, clean_autotune):
    cache = tmp_path / "tune.json"
    cache.write_text(json.dumps({"version": 99, "entries": {}}))
    autotune.set_cache_path(cache)
    n_events = len(autotune.events())
    autotune.get_blocks("fused", None, **KEY)
    assert autotune.events()[n_events:] == [
        ("autotune_cache_ignored", str(cache), "stale schema version 99")]


def test_malformed_cache_entry_ignored_with_event(tmp_path, clean_autotune):
    """One bad entry is skipped (with an event); good entries still load."""
    good_key = autotune.cache_key("fused", **KEY)
    bad_key = autotune.cache_key("fused", **dict(KEY, precision="bf16"))
    cache = tmp_path / "tune.json"
    cache.write_text(json.dumps({"version": 1, "entries": {
        good_key: {"pipeline": "dma"}, bad_key: {"pipeline": ["dma"]}}}))
    autotune.set_cache_path(cache)
    n_events = len(autotune.events())
    assert autotune.get_blocks("fused", None, **KEY) == {"pipeline": "dma"}
    assert autotune.events()[n_events:] == [
        ("autotune_cache_entry_ignored", str(cache), bad_key)]


def test_fit_surfaces_cache_ignored_event_in_trace(tmp_path, clean_autotune):
    """A corrupt cache file is reported in the fit's trace (``fit`` loads
    the cache up front, so this holds on the CPU too), not fatal."""
    cache = tmp_path / "tune.json"
    cache.write_text("%% corrupt %%")
    autotune.set_cache_path(cache)
    X = np.random.default_rng(3).normal(size=(4_200, 9)).astype(np.float32)
    cfg = api.BigMeansConfig(k=7, s=600, n_chunks=2, autotune=True)
    res = api.fit(X, cfg, device="cpu")
    assert np.isfinite(res.objective)
    evs = [t for t in res.trace if t[0] == "autotune_cache_ignored"]
    assert len(evs) == 1 and evs[0][1] == str(cache), res.trace
    assert len(res.trace) == cfg.n_chunks + 1


@pytest.mark.parametrize("was", [False, True])
def test_fit_restores_enable_state(clean_autotune, monkeypatch, was):
    """fit(autotune=True) tunes for the call's duration only, exception
    paths included."""
    autotune.enable(was)
    X = np.random.default_rng(1).normal(size=(5_000, 8)).astype(np.float32)
    cfg = api.BigMeansConfig(k=4, s=512, n_chunks=4, autotune=True)
    seen = []
    real = api._pretune

    def spy(*args):
        seen.append(autotune.enabled())
        real(*args)

    monkeypatch.setattr(api, "_pretune", spy)
    res = api.fit(X, cfg, device="cpu")
    assert seen == [True] and autotune.enabled() is was
    assert np.isfinite(res.objective)

    def boom(*args):
        raise RuntimeError("pretune failed")

    monkeypatch.setattr(api, "_pretune", boom)
    with pytest.raises(RuntimeError, match="pretune failed"):
        api.fit(X, cfg, device="cpu")
    assert autotune.enabled() is was


def test_candidates_start_with_default_and_contain_dma():
    shape = dict(b=1, m=64_000, k=25, n=28, precision="f32")
    fused = autotune.candidates("fused", **shape)
    assert fused[0] == {"pipeline": "blocks"}
    assert {"pipeline": "dma"} in fused
    assert all(set(c) == {"pipeline"} and c["pipeline"]
               in fused_step.PIPELINES for c in fused)
    assign = autotune.candidates("assign", **shape)
    assert assign[0] == {"ctas_per_sm": 2}
    assert sorted(c["ctas_per_sm"] for c in assign) == [1, 2, 4]
    assert autotune.candidates("fused_batched", **dict(shape, b=8)) == [{}]
    with pytest.raises(ValueError, match="unknown autotune kind"):
        autotune.candidates("nope", **shape)


def test_unknown_pipeline_raises():
    x, c = (torch.from_numpy(a) for a in blobs(64, 4, 8))
    for call in (lambda: fused_step.fused_step_f32(x, c, pipeline="prefetch"),
                 lambda: fused_step.fused_step_16(x, c, "bf16",
                                                  pipeline="prefetch"),
                 lambda: fused_step.fused_step_int8(x, c,
                                                    pipeline="prefetch"),
                 lambda: fused_step.fused_step_plain(x, c,
                                                     pipeline="prefetch")):
        with pytest.raises(ValueError, match="unknown pipeline"):
            call()
    for pipeline in fused_step.PIPELINES:   # the plain versions ignore it
        got = fused_step.fused_step_plain(x, c, pipeline=pipeline)
        assert all(torch.equal(a, b) for a, b in
                   zip(got, fused_step.fused_step_plain(x, c)))


def test_failing_candidate_raises(clean_autotune):
    """No fallback: a candidate whose bench raises makes the lookup raise,
    naming it, and nothing is cached."""
    autotune.enable(True)

    def bench_factory(blocks):
        def run():
            if blocks["pipeline"] == "dma":
                raise RuntimeError("launch refused")
        return run

    with pytest.raises(RuntimeError, match=r"candidate \{'pipeline': 'dma'\}"):
        autotune.get_blocks("fused", bench_factory, **KEY)
    autotune.enable(False)
    assert autotune.get_blocks("fused", None, **KEY) == {"pipeline": "blocks"}


def test_shared_cache_file_keeps_both_packages_entries(tmp_path,
                                                       clean_autotune):
    """Keys have the reference's form with a ``cuda-sm_*`` backend, and
    merge-on-write keeps the reference's entries in a shared file (and the
    reference's keeps the port's)."""
    cache = tmp_path / "shared.json"
    jkw = dict(backend="interpret", b=1, m=256, k=25, n=20, precision="f32")
    assert autotune.cache_key("fused", **KEY) == jautotune.cache_key(
        "fused", **dict(jkw, backend="cuda-sm_90"))
    was = jautotune.enabled(), jautotune.cache_path()
    try:
        jautotune.clear()
        jautotune.set_cache_path(cache)
        jautotune.enable(True)
        jautotune.get_blocks("fused", lambda blk: (lambda: None), **jkw)
        autotune.set_cache_path(cache)
        autotune.enable(True)
        autotune.get_blocks("fused", counting_bench([]), **KEY)
        jautotune.clear()
        jautotune.get_blocks("assign", lambda blk: (lambda: None), **jkw)
    finally:
        jautotune.clear()
        jautotune.enable(was[0])
        jautotune.set_cache_path(was[1])
    entries = json.loads(cache.read_text())["entries"]
    assert set(entries) == {jautotune.cache_key("fused", **jkw),
                            jautotune.cache_key("assign", **jkw),
                            autotune.cache_key("fused", **KEY)}


def test_cpu_tensors_never_consult_the_tuner(clean_autotune, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the tuner was consulted for CPU tensors")

    monkeypatch.setattr(autotune, "get_blocks", refuse)
    autotune.enable(True)
    x, c = (torch.from_numpy(a) for a in blobs(300, 5, 8))
    ops.fused_step(x, c)
    ops.assign(x, c)
    ops.fused_step_batched(x[None], c[None])
    X = np.random.default_rng(2).normal(size=(2_000, 6)).astype(np.float32)
    api.fit(X, api.BigMeansConfig(k=3, s=300, n_chunks=2, autotune=True),
            device="cpu")


@pytest.fixture(scope="module")
def road3d():
    spec = get_dataset("road3d-24k")
    X = np.asarray(gmm_dataset(spec.gmm))
    return spec, X, dict(k=spec.k, s=spec.s, n_chunks=spec.n_chunks)


@pytest.mark.parametrize("batch", [1, 4], ids=["sequential", "batched"])
def test_cpu_autotuned_fit_is_the_untuned_fit(road3d, clean_autotune, batch):
    """On the CPU, fit(autotune=True) is bitwise fit(autotune=False)."""
    _, X, cfg = road3d
    cfg = api.BigMeansConfig(**cfg, batch=batch, sync_every=2)
    tuned = api.fit(X, cfg, autotune=True, device="cpu", rng=REPLAY)
    plain = api.fit(X, cfg, device="cpu", rng=REPLAY)
    assert torch.equal(tuned.centroids, plain.centroids)
    assert tuned.trace == plain.trace
    assert tuned.objective == plain.objective
    assert tuned.n_iterations == plain.n_iterations
    assert tuned.extras["fit"]["autotune"] is True
    assert plain.extras["fit"]["autotune"] is False


def test_cpu_autotuned_fit_matches_reference(road3d, clean_autotune):
    """Decision by decision (the jax-replay key tree) the reference's
    ``fit(..., impl="ref", autotune=True)``: the same accepts, Lloyd
    iterations and n_accepted; objectives and centroids within 1e-5 (the
    summation order differs)."""
    _, X, cfg = road3d
    was = autotune.enabled(), jautotune.enabled()
    want = japi.fit(X, japi.BigMeansConfig(**cfg, autotune=True),
                    method="sequential", impl="ref")
    _, infos = jbm.big_means(X, jax.random.PRNGKey(0), impl="ref", **cfg)
    got = api.fit(X, api.BigMeansConfig(**cfg, autotune=True),
                  method="sequential", device="cpu", rng=REPLAY)
    assert [a for _, _, a in got.trace] == [a for _, _, a in want.trace]
    assert got.n_accepted == want.n_accepted
    assert got.n_iterations == want.n_iterations == int(
        np.sum(np.asarray(infos.lloyd_iters)))
    np.testing.assert_allclose([f for _, f, _ in got.trace],
                               [f for _, f, _ in want.trace], rtol=1e-5)
    ref_c = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), ref_c, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref_c).max()))
    assert (autotune.enabled(), jautotune.enabled()) == was
