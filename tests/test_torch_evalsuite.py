"""Parity of the port's reproduction suite with the reference's.

``repro_torch.evalsuite`` (schema, metrics, gate, dataset registry, suite
runner, host cell), ``BigMeansConfig.resolved_impl`` / ``from_workload``,
``repro_torch.configs.bigmeans_paper`` and ``repro_torch.launch.roofline``
against ``repro.evalsuite``, ``repro.api.config``,
``repro.configs.bigmeans_paper`` and ``repro.launch.roofline``, on the
CPU.  Both packages get the same numpy inputs: the suite rows read one
numpy memmap, and the port draws through the jax-replay backend of
``test_torch_rng``, so its decisions are the reference's; floats differ
by summation order only (``RTOL``).
"""
import copy
import dataclasses
import json
import math
import os
import time
import types
import warnings

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.configs import bigmeans_paper as jpaper
from repro.evalsuite import datasets as jds
from repro.evalsuite import gate as jgate
from repro.evalsuite import metrics as jmetrics
from repro.evalsuite import schema as jschema
from repro.evalsuite import suite as jsuite
from repro.launch import roofline as jroof
from repro_torch import api
from repro_torch.configs import bigmeans_paper as paper
from repro_torch.evalsuite import datasets as pds
from repro_torch.evalsuite import gate as pgate
from repro_torch.evalsuite import hostcell
from repro_torch.evalsuite import metrics as pmetrics
from repro_torch.evalsuite import schema as pschema
from repro_torch.evalsuite import suite as psuite
from repro_torch.launch import roofline as proof
from test_torch_rng import REPLAY

RTOL = 1e-5
CPU_HOST = pschema.host_info("cpu")


def _suite_doc(metrics=pmetrics, schema=pschema, **host) -> dict:
    """The reference test's hand-built, schema-valid suite document
    (``tests/test_evalsuite.py:_suite_doc``), built by either package."""
    rows = [
        {"dataset": "d0", "method": "bm/sequential", "kind": "bigmeans",
         "seed": s, "f_full": f, "epsilon": (f - 100.0) / 100.0,
         "success": f <= 105.0, "wall_s": w, "n_chunks": 8,
         "n_iterations": 40, "n_accepted": 3}
        for s, f, w in [(0, 100.0, 2.0), (1, 104.0, 1.0), (2, 110.0, 3.0)]
    ]
    cells = [metrics.aggregate_cell("d0", "bm/sequential", "bigmeans", rows,
                                    success_tol=0.05)]
    return schema.envelope(
        "suite", rows, tier="quick", success_tol=0.05, protocol="test",
        datasets=[{"name": "d0", "paper_name": "kegg", "m": 1000, "n": 20,
                   "k": 5, "s": 100, "n_chunks": 8, "f_star": 100.0}],
        cells=cells, **host)


# ---------------------------------------------------------------- schema

def test_schemas_and_version_are_the_references():
    assert pschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    for name in ("ENVELOPE_SCHEMA", "SUITE_SCHEMA", "_HOST_SCHEMA",
                 "_DATASET_SCHEMA", "_ROW_SCHEMA", "_CELL_SCHEMA"):
        assert getattr(pschema, name) == getattr(jschema, name), name


def test_port_doc_equals_reference_doc_but_the_host():
    port = _suite_doc(host=CPU_HOST)
    ref = _suite_doc(jmetrics, jschema)
    assert {k: v for k, v in port.items() if k != "host"} == \
        {k: v for k, v in ref.items() if k != "host"}
    assert CPU_HOST == {"cpu_count": os.cpu_count(), "xla_devices": 1,
                        "backend": "cpu", "device": "cpu",
                        "power_limit": None}


@pytest.mark.parametrize("mutate, fragment", [
    (lambda d: d.pop("cells"), "missing required field 'cells'"),
    (lambda d: d.update(schema_version="bogus/9"), "expected"),
    (lambda d: d.update(tier="weekly"), "not in"),
    (lambda d: d["rows"][0].update(wall_s="fast"), "expected type"),
    (lambda d: d["rows"][0].pop("epsilon"), "missing required"),
    (lambda d: d.update(rows=[]), ">= 1 items"),
    (lambda d: d["cells"][0].update(success_rate=-0.5), "minimum"),
], ids=["cells", "version", "tier", "wall_type", "epsilon", "rows",
        "success_rate"])
def test_corruptions_give_the_references_errors(mutate, fragment):
    doc = _suite_doc(host=CPU_HOST)
    mutate(doc)
    errors = pschema.validate(doc, pschema.SUITE_SCHEMA)
    assert errors and any(fragment in e for e in errors), errors
    assert errors == jschema.validate(doc, jschema.SUITE_SCHEMA)
    assert pschema.validate(doc, pschema.ENVELOPE_SCHEMA) == \
        jschema.validate(doc, jschema.ENVELOPE_SCHEMA)


def test_check_raises_and_write_bench_refuses(tmp_path):
    doc = _suite_doc(host=CPU_HOST)
    del doc["rows"][0]["epsilon"], doc["rows"][1]["f_full"]
    with pytest.raises(ValueError, match="2 error"):
        pschema.check(doc, pschema.SUITE_SCHEMA)
    with pytest.raises(ValueError, match="unsupported schema keywords"):
        pschema.validate({}, {"type": "object", "patternProperties": {}})
    bad = pschema.envelope("x", rows=[{"a": 1}], host=CPU_HOST)
    del bad["host"]
    with pytest.raises(ValueError, match="host"):
        pschema.write_bench(str(tmp_path / "b.json"), bad)
    assert not (tmp_path / "b.json").exists()
    good = pschema.envelope("x", rows=[{"a": 1}], host=CPU_HOST)
    path = pschema.write_bench(str(tmp_path / "g.json"), good)
    with open(path) as f:
        assert jschema.validate(json.load(f), jschema.ENVELOPE_SCHEMA) == []


# --------------------------------------------------------------- metrics

def _runs(seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(90.0, 130.0, size=7)
    eps = [(v - 100.0) / 100.0 for v in f]
    eps[3] = math.nan
    walls = rng.uniform(0.1, 5.0, size=7).tolist()
    rows = [{"epsilon": e, "wall_s": w, "success": e <= 0.05}
            for e, w in zip(eps, walls)]
    return f, eps, walls, rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_references(seed):
    f, eps, walls, rows = _runs(seed)
    for v in f:
        assert pmetrics.relative_error(v, 100.0) == \
            jmetrics.relative_error(v, 100.0)
    for bad in (0.0, math.nan, math.inf):
        with pytest.raises(ValueError):
            pmetrics.relative_error(1.0, bad)
    for tol in (0.0, 0.05, 0.2):
        assert pmetrics.success_rate(eps, tol) == \
            jmetrics.success_rate(eps, tol)
    runs = [(r["wall_s"], r["success"]) for r in rows]
    for grid in (None, [0.5, 1.0, 10.0], [0.01]):
        assert pmetrics.time_to_target_curve(runs, grid) == \
            jmetrics.time_to_target_curve(runs, grid)
    assert pmetrics.time_to_target_curve([(4.0, False)]) == \
        jmetrics.time_to_target_curve([(4.0, False)])
    rows = [r for r in rows if not math.isnan(r["epsilon"])]
    for tol in (0.05, 0.3):
        assert pmetrics.aggregate_cell("d", "m", "bigmeans", rows,
                                       success_tol=tol) == \
            jmetrics.aggregate_cell("d", "m", "bigmeans", rows,
                                    success_tol=tol)
    with pytest.raises(ValueError):
        pmetrics.success_rate([], 0.05)
    with pytest.raises(ValueError):
        pmetrics.aggregate_cell("d", "m", "bigmeans", [], success_tol=0.05)


# ------------------------------------------------------------------ gate

def _extra_cell(doc):
    extra = copy.deepcopy(doc["cells"][0])
    extra["method"] = "bm/new"
    doc["cells"].append(extra)


GATE_CASES = {
    "identical": (lambda b, f: None, {}),
    "eps_up": (lambda b, f: f["cells"][0].update(
        epsilon_mean=f["cells"][0]["epsilon_mean"] + 0.06), {}),
    "eps_down": (lambda b, f: f["cells"][0].update(
        epsilon_mean=f["cells"][0]["epsilon_mean"] - 0.06), {}),
    "success_drop": (lambda b, f: f["cells"][0].update(success_rate=0.0),
                     {}),
    "wall_ratio": (lambda b, f: f["cells"][0].update(
        wall_mean_s=f["cells"][0]["wall_mean_s"] * 3.0), {}),
    "no_wall": (lambda b, f: f["cells"][0].update(
        wall_mean_s=f["cells"][0]["wall_mean_s"] * 3.0),
        {"check_wall": False}),
    "wall_floor": (lambda b, f: (b["cells"][0].update(wall_mean_s=0.01),
                                 f["cells"][0].update(wall_mean_s=0.4)), {}),
    "new_cell": (lambda b, f: _extra_cell(f), {}),
    "missing_cell": (lambda b, f: _extra_cell(b), {}),
    "beat_f_star": (lambda b, f: f["cells"][0].update(epsilon_min=-0.01),
                    {}),
    "f_star_differs": (lambda b, f: f["datasets"][0].update(f_star=99.0),
                       {}),
    "schema_invalid": (lambda b, f: f["cells"][0].pop("epsilon_mean"), {}),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_compare_equals_the_references(case):
    mutate, kw = GATE_CASES[case]
    base, fresh = _suite_doc(host=CPU_HOST), _suite_doc(host=CPU_HOST)
    mutate(base, fresh)
    got = pgate.compare(base, fresh, **kw)
    want = jgate.compare(copy.deepcopy(base), copy.deepcopy(fresh), **kw)
    assert (got.failures, got.warnings, got.checked, got.ok) == \
        (want.failures, want.warnings, want.checked, want.ok)
    assert got.report() == want.report()
    expect_ok = case not in ("eps_up", "success_drop", "wall_ratio",
                             "missing_cell", "schema_invalid")
    assert got.ok == expect_ok


def test_gate_main_exit_codes(tmp_path, capsys):
    doc = _suite_doc(host=CPU_HOST)
    base = tmp_path / "base.json"
    base.write_text(json.dumps(doc))
    report = tmp_path / "report.txt"
    assert pgate.main(["--baseline", str(base), "--fresh", str(base),
                       "--report", str(report)]) == 0
    assert "PASS" in report.read_text()
    worse = copy.deepcopy(doc)
    for cell in worse["cells"]:
        cell["epsilon_mean"] += 0.2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(worse))
    assert pgate.main(["--baseline", str(base), "--fresh", str(bad),
                       "--report", str(report)]) == 1
    assert "FAIL" in report.read_text()
    _extra_cell(doc)
    base.write_text(json.dumps(doc))
    dropped = copy.deepcopy(doc)
    dropped["cells"].pop()
    gone = tmp_path / "gone.json"
    gone.write_text(json.dumps(dropped))
    assert pgate.main(["--baseline", str(base), "--fresh", str(gone),
                       "--no-wall"]) == 1
    assert "coverage regressed" in capsys.readouterr().out
    with pytest.raises(SystemExit):      # --baseline has no default
        pgate.main(["--fresh", str(base)])


# -------------------------------------------------- datasets / registry

@pytest.mark.parametrize("name", jds.list_datasets())
def test_registry_entry_is_the_references_but_f_star(name):
    got, want = pds.get_dataset(name), jds.get_dataset(name)
    for f in dataclasses.fields(want):
        if f.name != "f_star":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert tuple(got.gmm) == tuple(want.gmm)
    rec = got.to_record()
    assert rec.keys() == want.to_record().keys()
    assert jschema.validate(rec, jschema._DATASET_SCHEMA) == []


def test_registry_tiers_and_lookup():
    assert pds.list_datasets() == jds.list_datasets()
    for tier in ("quick", "full"):
        assert pds.list_datasets(tier) == jds.list_datasets(tier)
    with pytest.raises(KeyError, match="unknown dataset"):
        pds.get_dataset("nope")


def test_registry_f_star_committed():
    """Every entry carries the port's own f* from the card's full tier
    (``chip_smoke.py`` phase 13b), none of them the reference's."""
    for name in pds.list_datasets():
        f_star = pds.get_dataset(name).f_star
        assert f_star is not None and f_star > 0, name
        assert f_star != jds.get_dataset(name).f_star, name


def test_no_entry_shares_the_references_file(tmp_path, monkeypatch):
    """Each package names its own file for every entry, in the same
    root too (the digest covers the generator), and by default in its own
    root."""
    touch = lambda spec, path, **kw: open(path, "wb").close()  # noqa: E731
    monkeypatch.setattr(jds, "gmm_memmap", touch)
    monkeypatch.setattr(pds, "gmm_memmap", touch)
    root = str(tmp_path)
    for name in pds.list_datasets():
        p = pds.materialize(pds.get_dataset(name), root)
        j = jds.materialize(jds.get_dataset(name), root)
        assert p != j and os.path.basename(p).startswith(name + "-")
    assert pds.default_root() != jds.default_root()


def test_cpu_generation_is_deterministic_and_reused(tmp_path):
    from repro_torch.data.synthetic import gmm_dataset

    spec = pds.DatasetSpec(name="t-tiny", paper_name="kegg", m=1500, n=20,
                           components=4, k=3, s=128, n_chunks=4)
    a = pds.materialize(spec, str(tmp_path / "a"))
    b = pds.materialize(spec, str(tmp_path / "b"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(
        np.load(a), gmm_dataset(spec.gmm, device="cpu").numpy())
    mtime = os.path.getmtime(a)
    assert pds.materialize(spec, str(tmp_path / "a")) == a
    assert os.path.getmtime(a) == mtime
    assert not [f for f in os.listdir(tmp_path / "a") if f.endswith(".tmp")]
    src = pds.source(spec, str(tmp_path / "a"))
    assert isinstance(src, api.MemmapSource) and src.n_rows == 1500


# ------------------------------------------------- suite rows, jax-replay

PARITY_METHODS = ["bm/sequential", "bm/batched", "baseline/forgy",
                  "baseline/kmeanspp", "baseline/coreset",
                  "baseline/da_mssc"]


@pytest.fixture(scope="module")
def shared_memmap(tmp_path_factory):
    """One numpy memmap from a seed (blobs, m = 3,000, n = 6) and a spec
    for it in each package."""
    rng = np.random.default_rng(27)
    c = rng.normal(size=(5, 6)) * 4.0
    x = (c[rng.integers(0, 5, 3000)] + rng.normal(size=(3000, 6)))
    path = str(tmp_path_factory.mktemp("suite") / "shared.npy")
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=x.shape)
    mm[:] = x
    mm.flush()
    del mm
    kw = dict(name="t-shared", paper_name="kegg", m=3000, n=6,
              components=5, k=4, s=256, n_chunks=8)
    return path, pds.DatasetSpec(**kw), jds.DatasetSpec(**kw)


def _methods(name):
    return (next(m for m in psuite.METHODS if m.name == name),
            next(m for m in jsuite.METHODS if m.name == name))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("method", PARITY_METHODS)
def test_run_cell_matches_the_reference_under_replay(shared_memmap, method,
                                                     seed):
    path, pspec, jspec = shared_memmap
    pm, jm = _methods(method)
    psrc, jsrc = api.MemmapSource(path), japi.MemmapSource(path)
    X = psrc.as_array()
    got = psuite._run_cell(pspec, pm, seed, psrc, X, False, device="cpu",
                           rng=REPLAY)
    want = jsuite._run_cell(jspec, jm, seed, jsrc, jsrc.as_array(), False)
    for key in ("dataset", "method", "kind", "seed", "n_chunks",
                "n_iterations", "n_accepted", "strategy"):
        assert got[key] == want[key], key
    for key in ("f_native", "f_full"):
        assert got[key] == pytest.approx(want[key], rel=RTOL), key
    assert got.keys() == want.keys()
    assert got["fit"]["impl"] == "ref" and got["fit"]["device"] == "cpu"


def test_method_matrix_is_the_references():
    strip = lambda m: (m.name, m.kind, m.method, m.overrides,  # noqa: E731
                       m.tiers, m.runner)
    assert [strip(m) for m in psuite.METHODS] == \
        [strip(m) for m in jsuite.METHODS]
    assert psuite.SEEDS == jsuite.SEEDS
    assert psuite.DEFAULT_SUCCESS_TOL == jsuite.DEFAULT_SUCCESS_TOL
    for tier in (None, "quick", "full"):
        assert psuite.list_methods(tier) == jsuite.list_methods(tier)
    assert "graph capture" in psuite.PROTOCOL


# ------------------------------------------------- suite (end to end)

class TestSuiteRun:
    @pytest.fixture(scope="class")
    def mini_doc(self, tmp_path_factory):
        """One tiny dataset x (one strategy + one baseline) x 2 seeds on
        the CPU, with the bootstrap f*."""
        spec = pds.DatasetSpec(name="t-mini", paper_name="kegg", m=1536,
                               n=20, components=6, k=4, s=192, n_chunks=4,
                               f_star=None, tiers=("quick",))
        pds.REGISTRY[spec.name] = spec
        try:
            yield psuite.run_suite(
                "quick", seeds=(0, 1), dataset_names=["t-mini"],
                method_names=["bm/sequential", "baseline/forgy"],
                data_root=str(tmp_path_factory.mktemp("evalsuite")),
                verbose=False, device="cpu")
        finally:
            del pds.REGISTRY[spec.name]

    def test_doc_valid_under_both_schemas(self, mini_doc):
        assert pschema.validate(mini_doc, pschema.SUITE_SCHEMA) == []
        assert jschema.validate(mini_doc, jschema.SUITE_SCHEMA) == []
        assert mini_doc["host"]["backend"] == "cpu"
        assert jgate.compare(mini_doc, copy.deepcopy(mini_doc)).ok

    def test_equal_budget_and_bootstrap_f_star(self, mini_doc):
        (record,) = mini_doc["datasets"]
        assert record["f_star_source"].startswith("run-best")
        best = min(r["f_full"] for r in mini_doc["rows"])
        assert record["f_star"] == best
        assert min(r["epsilon"] for r in mini_doc["rows"]) == \
            pytest.approx(0.0)
        for r in mini_doc["rows"]:
            assert r["success"] == (r["epsilon"] <= mini_doc["success_tol"])
            if r["kind"] == "bigmeans":
                assert r["n_chunks"] == 4

    def test_cells_cover_matrix(self, mini_doc):
        keys = {(c["dataset"], c["method"]) for c in mini_doc["cells"]}
        assert keys == {("t-mini", "bm/sequential"),
                        ("t-mini", "baseline/forgy")}

    def test_write_outputs(self, mini_doc, tmp_path):
        json_path = str(tmp_path / "BENCH_suite.json")
        csv_path = str(tmp_path / "runs.csv")
        psuite.write_outputs(mini_doc, json_path, csv_path)
        with open(json_path) as f:
            assert jschema.validate(json.load(f), jschema.SUITE_SCHEMA) == []
        with open(csv_path) as f:
            lines = f.read().strip().splitlines()
        assert len(lines) == 1 + len(mini_doc["rows"])

    def test_reference_doc_passes_the_ports_schema(self, tmp_path):
        spec = jds.DatasetSpec(name="t-mini", paper_name="kegg", m=1536,
                               n=20, components=6, k=4, s=192, n_chunks=4,
                               f_star=None, tiers=("quick",))
        jds.REGISTRY[spec.name] = spec
        try:
            doc = jsuite.run_suite(
                "quick", seeds=(0,), dataset_names=["t-mini"],
                method_names=["baseline/forgy"], data_root=str(tmp_path),
                verbose=False)
        finally:
            del jds.REGISTRY[spec.name]
        assert pschema.validate(doc, pschema.SUITE_SCHEMA) == []
        assert pgate.compare(doc, copy.deepcopy(doc)).ok

    def test_unknown_method_or_tier_raises(self):
        with pytest.raises(KeyError, match="unknown methods"):
            psuite.run_suite("quick", device="cpu",
                             method_names=["bm/seqential", "baseline/forgy"])
        with pytest.raises(ValueError, match="unknown tier"):
            psuite.run_suite("weekly", device="cpu")


# ------------------------------------------------------------ host cell

def test_host_cell_two_ranks_equal_one_process(tmp_path, monkeypatch):
    """Two ranks on the CPU (hepmass-16k, seed 0): the row is the
    single-process streaming fit's (f_native bitwise, n_chunks the fleet
    total), and neither child imports jax (a ``jax`` that refuses to
    import stands first on the children's path).  The children run one
    CPU thread each, and so does the single-process fit: PyTorch's CPU
    products split their sums by the thread count."""
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('the host cell must not import jax')\n")
    old = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", str(fake.parent) + (
        os.pathsep + old if old else ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = str(tmp_path / "data")
    spec = pds.get_dataset("hepmass-16k")
    m = next(x for x in psuite.METHODS if x.name == "bm/hostmesh-2p")
    t0 = time.monotonic()
    row = hostcell.run_cell(spec, m, 0, data_root=root, verbose=False,
                            device="cpu", timeout_s=120)
    took = time.monotonic() - t0
    over = {k: v for k, v in m.overrides.items() if k != "hosts"}
    cfg = api.BigMeansConfig(k=spec.k, s=spec.s, n_chunks=spec.n_chunks,
                             seed=0, log_every=0, **over)
    src = pds.source(spec, root)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # the children's one thread: same sums
    try:
        one = api.fit(src, cfg, method="streaming", device="cpu")
        _, f_full = api.evaluate(one, src.as_array(), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert row["f_native"] == one.objective
    assert row["f_full"] == f_full
    assert row["n_chunks"] == spec.n_chunks == one.n_chunks
    assert (row["n_iterations"], row["n_accepted"]) == \
        (one.n_iterations, one.n_accepted)
    assert row["fit"]["hosts"] == 2 and row["fit"]["device"] == "cpu"
    assert row["strategy"] == "streaming" and row["wall_s"] > 0
    assert took < 60.0, took


def test_host_cell_child_failure_raises(tmp_path):
    spec = pds.get_dataset("hepmass-16k")
    m = psuite.MethodSpec("bm/bad", "bigmeans", "streaming",
                          {"batch": 3, "hosts": 2}, runner="host2p")
    with pytest.raises(RuntimeError, match="hostcell rank 0 failed"):
        hostcell.run_cell(spec, m, 0, data_root=str(tmp_path),
                          verbose=False, device="cpu", timeout_s=120)


# --------------------------------------------------------------- config

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "topology"} | {"topology": cfg.topology.kind}


def test_from_workload_paper_config_is_the_references():
    got = api.BigMeansConfig.from_workload(paper.CONFIG, n_chunks=32)
    want = japi.BigMeansConfig.from_workload(jpaper.CONFIG, n_chunks=32)
    assert _fields(got) == _fields(want)
    assert (got.k, got.s, got.n_chunks, got.batch, got.sync_every) == \
        (25, 64_000, 32, 8, 2)
    assert api.BigMeansConfig.from_workload(paper.CONFIG) is \
        paper.CONFIG.algo
    assert (paper.CONFIG.m, paper.CONFIG.n_features) == \
        (jpaper.CONFIG.m, jpaper.CONFIG.n_features)
    for prop in ("k", "s", "chunks_per_worker", "sync_every", "max_iters",
                 "tol", "candidates", "batch", "prefetch"):
        assert getattr(paper.CONFIG, prop) == getattr(jpaper.CONFIG, prop)


def test_from_workload_legacy_duck_type_is_the_references():
    wl = types.SimpleNamespace(k=7, s=300, chunks_per_worker=12,
                               sync_every=3, batch=4, prefetch=0, tol=1e-3,
                               precision="bf16")
    got = api.BigMeansConfig.from_workload(wl, seed=5)
    want = japi.BigMeansConfig.from_workload(wl, seed=5)
    assert _fields(got) == _fields(want)
    bare = types.SimpleNamespace(k=3, s=50)
    assert _fields(api.BigMeansConfig.from_workload(bare)) == \
        _fields(japi.BigMeansConfig.from_workload(bare))


def test_legacy_workload_keywords_warn_as_the_references():
    kw = dict(k=10, s=500, chunks_per_worker=3, batch=2)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = paper.BigMeansWorkload(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jpaper.BigMeansWorkload(**kw)
    assert _fields(api.BigMeansConfig.from_workload(got)) == \
        _fields(japi.BigMeansConfig.from_workload(want))
    assert got.chunks_per_worker == 3 and got.k == 10
    with pytest.raises(TypeError, match="unknown BigMeansWorkload"):
        paper.BigMeansWorkload(rounds=3)


def test_resolved_impl_on_the_cpu():
    cfg = api.BigMeansConfig(k=3, s=10)
    assert cfg.resolved_impl("cpu") == "ref"
    assert japi.BigMeansConfig(k=3, s=10).resolved_impl() == "ref"
    assert cfg.replace(impl="ref_chunked").resolved_impl("cpu") == \
        "ref_chunked"
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        cfg.replace(impl="cuda").resolved_impl("cpu")
    res = api.fit(np.zeros((64, 3), np.float32) + np.arange(64)[:, None],
                  cfg, device="cpu")
    assert res.to_row()["fit"]["impl"] == cfg.resolved_impl("cpu")


# ------------------------------------------------------------- roofline

SHAPES = [(64_000, 28, 25), (16_384, 1_024, 2_048), (2_048, 3, 15)]


@pytest.mark.parametrize("shape", SHAPES, ids=["hepmass", "two_pass",
                                               "road3d"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x3", "int8"])
def test_traffic_model_is_the_references(shape, precision):
    s, n, k = shape
    assert proof.chunk_bytes(s, n, precision) == \
        jroof.chunk_bytes(s, n, precision)
    for passes in (2, 5.25):
        assert proof.chunk_traffic(s, n, k, precision, passes) == \
            jroof.chunk_traffic(s, n, k, precision, passes)


def test_roofline_terms_by_hand():
    peaks = {"f32": 67e12, "bf16": 989e12, "bf16x3": 989e12 / 3,
             "int8": 1979e12}
    assert proof.PEAK_FLOPS == peaks
    assert (proof.HBM_BW, proof.NVLINK_BW) == (3.35e12, 900e9)
    for prec, peak in peaks.items():
        t = proof.roofline_terms(6.7e12, 3.35e9, 0.0, precision=prec)
        assert t["compute_s"] == 6.7e12 / peak
        assert t["memory_s"] == 3.35e9 / 3.35e12
        assert t["collective_s"] == 0.0
        assert t["bound_s"] == max(t["compute_s"], t["memory_s"])
        assert t["dominant"] == ("compute" if 6.7e12 / peak > 1e-3
                                 else "memory")
        assert t["roofline_fraction"] == t["compute_s"] / t["bound_s"]
    t = proof.roofline_terms(0.0, 0.0, 9e9)
    assert t["collective_s"] == 0.01 and t["dominant"] == "collective"
    assert proof.roofline_terms(0.0, 0.0)["roofline_fraction"] == 0.0


def test_precision_roofline_on_a_measured_row():
    row = {"s": 64_000, "n": 28, "k": 25, "precision": "int8", "batch": 8,
           "lloyd_iters_per_chunk": 3.25, "chunks_per_s": 400.0}
    got = proof.precision_roofline(row)
    want = jroof.precision_roofline(row)
    traffic = jroof.chunk_traffic(64_000, 28, 25, "int8", 5.25)
    assert got["model_bytes_per_chunk"] == want["model_bytes_per_chunk"] \
        == traffic["bytes"]
    assert got["model_flops_per_chunk"] == traffic["flops"]
    assert got["passes"] == 5.25 and got["batch"] == 8
    assert got["achieved_bytes_per_s"] == round(400.0 * traffic["bytes"], 1)
    assert got["achieved_frac_of_peak"] == round(
        400.0 * traffic["bytes"] / 3.35e12, 8)
    assert got["compute_s"] == traffic["flops"] / 1979e12
    assert got["dominant"] == "memory"
    assert got["arithmetic_intensity"] == want["arithmetic_intensity"]

