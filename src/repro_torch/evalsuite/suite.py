"""The suite runner: §5's quality/speed comparison as one artifact.

The reference's ``repro.evalsuite.suite``: sweeps the same method matrix —
Big-means execution strategies × precision × scheduler, plus the §5
baselines — over the dataset registry, every call through
:func:`repro_torch.api.fit` and :func:`repro_torch.api.evaluate`, and
emits one schema-validated suite document plus a per-run CSV.

Equal-budget protocol (the paper's comparison rule): every Big-means cell
on a dataset gets the SAME total chunk budget ``n_chunks × s`` from the
registry spec, whatever its strategy, batch width, precision or
scheduler.  Baselines are full-data algorithms; they run the paper's §5
protocol on the identical dataset and are compared on the same full-data
objective f(C, X) and wall clock.

:func:`run_suite` runs on the card unless ``device="cpu"`` is passed, and
raises without a card otherwise.  ``rng=`` is the key-tree backend of the
in-process cells (the tests pass the jax-replay backend); the host cell's
ranks draw with the package's own.  The untimed warm-up fit of each cell
keeps the kernels' build and load at first use out of the timed walls.

Tiers: ``quick`` (the small-m datasets, 2 seeds) and ``full`` (all
datasets, 5 seeds, the bf16 / int8 and competitive-scheduler cells).
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Sequence

from repro_torch import device as devices
from repro_torch.evalsuite import datasets as ds
from repro_torch.evalsuite import metrics, schema

DEFAULT_SUCCESS_TOL = 0.05        # a run "succeeds" if ε <= 5% of f*
SEEDS = {"quick": (0, 1), "full": (0, 1, 2, 3, 4)}

PROTOCOL = (
    "equal-budget: every big-means cell gets the dataset's n_chunks x s "
    "sample budget regardless of strategy/batch/precision/scheduler; "
    "baselines run their §5 full-data protocol on the identical memmap; "
    "all cells compared on full-data f(C, X) and wall seconds; "
    "one untimed warm-up fit per cell excludes the kernels' build and "
    "load at first use and any graph capture from walls; "
    "epsilon = (f - f_star)/f_star vs the committed best-known f_star"
)


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One column of the comparison matrix.

    ``method`` is what :func:`repro_torch.api.fit` receives;
    ``overrides`` are applied on top of the dataset's protocol config
    (strategy knobs only — never ``k``/``s``/``n_chunks``, which the
    equal-budget rule owns).  ``runner`` picks the execution harness:
    ``"fit"`` runs in-process, ``"host2p"`` launches a multi-process
    ``host_mesh`` fleet per seed (:mod:`repro_torch.evalsuite.hostcell`;
    ``overrides['hosts']`` sizes it).
    """

    name: str
    kind: str                      # "bigmeans" | "baseline"
    method: str
    overrides: dict = dataclasses.field(default_factory=dict)
    tiers: tuple = ("quick", "full")
    runner: str = "fit"            # "fit" (in-process) | "host2p"


METHODS: tuple[MethodSpec, ...] = (
    # Big-means strategy x precision x scheduler cells
    MethodSpec("bm/sequential", "bigmeans", "sequential"),
    MethodSpec("bm/batched", "bigmeans", "batched", {"batch": 4}),
    MethodSpec("bm/batched-bf16", "bigmeans", "batched",
               {"batch": 4, "precision": "bf16"}, tiers=("full",)),
    MethodSpec("bm/batched-int8", "bigmeans", "batched",
               {"batch": 4, "precision": "int8"}, tiers=("full",)),
    MethodSpec("bm/competitive-s", "bigmeans", "streaming",
               {"batch": 4, "scheduler": "competitive_s", "sync_every": 2},
               tiers=("full",)),
    # cross-host incumbent exchange: the equal-budget streaming protocol
    # split over a 2-process host mesh (bitwise the single-process run;
    # run_cell checks that the ranks agree)
    MethodSpec("bm/hostmesh-2p", "bigmeans", "streaming",
               {"batch": 4, "sync_every": 2, "hosts": 2},
               runner="host2p"),
    # §5 baselines (full-data competitors through the same fit())
    MethodSpec("baseline/forgy", "baseline", "forgy"),
    MethodSpec("baseline/kmeanspp", "baseline", "kmeanspp"),
    MethodSpec("baseline/coreset", "baseline", "coreset"),
    MethodSpec("baseline/da_mssc", "baseline", "da_mssc", tiers=("full",)),
)


def list_methods(tier: str | None = None) -> list[str]:
    return [m.name for m in METHODS if tier is None or tier in m.tiers]


def _run_cell(spec: ds.DatasetSpec, m: MethodSpec, seed: int, source, X,
              verbose: bool, *, device=None, rng=None) -> dict:
    from repro_torch.api import BigMeansConfig, evaluate, fit

    cfg = BigMeansConfig(k=spec.k, s=spec.s, n_chunks=spec.n_chunks,
                         seed=seed, log_every=0, **m.overrides)
    result = fit(source, cfg, method=m.method, device=device, rng=rng)
    _, f_full = evaluate(result, X, device=device)
    base = result.to_row()                 # the FitResult row contract
    row = {
        "dataset": spec.name,
        "method": m.name,
        "kind": m.kind,
        "seed": seed,
        "f_full": float(f_full),
        "f_native": base["objective"],
        "wall_s": base["wall_time_s"],
        "n_chunks": base["n_chunks"],
        "n_iterations": base["n_iterations"],
        "n_accepted": base["n_accepted"],
        "strategy": base["strategy"],
        "fit": base["fit"],
    }
    if verbose:
        print(f"[suite] {spec.name:14s} {m.name:22s} seed={seed} "
              f"f={f_full:.5e}  wall={row['wall_s']:6.2f}s", flush=True)
    return row


def run_suite(
    tier: str = "full",
    *,
    seeds: Sequence[int] | None = None,
    dataset_names: Sequence[str] | None = None,
    method_names: Sequence[str] | None = None,
    data_root: str | None = None,
    success_tol: float = DEFAULT_SUCCESS_TOL,
    verbose: bool = True,
    device=None,
    rng=None,
) -> dict:
    """Run the sweep; return the (schema-valid) suite document.

    ``dataset_names`` / ``method_names`` restrict the matrix (tests use a
    single tiny cell); default is everything in ``tier``.  ``device``:
    the card unless ``"cpu"``; ``rng``: the in-process cells' backend.
    """
    if tier not in ("quick", "full"):
        raise ValueError(f"unknown tier {tier!r}; known: quick, full")
    seeds = tuple(seeds if seeds is not None else SEEDS[tier])
    specs = [ds.get_dataset(n)
             for n in (dataset_names or ds.list_datasets(tier))]
    if method_names is not None:
        unknown = set(method_names) - {m.name for m in METHODS}
        if unknown:
            raise KeyError(
                f"unknown methods {sorted(unknown)}; known: {list_methods()}")
        methods = [m for m in METHODS if m.name in method_names]
    else:
        methods = [m for m in METHODS if tier in m.tiers]
    if not specs or not methods or not seeds:
        raise ValueError("empty sweep: need >=1 dataset, method and seed")
    dev = devices.resolve(device)

    rows: list[dict] = []
    dataset_records = []
    for spec in specs:
        source = ds.source(spec, data_root)
        X = source.as_array()
        ds_rows = []
        for m in methods:
            if m.runner == "host2p":
                # Each fleet is new processes (the kernels loaded anew), so
                # there is no warm-up to run: these walls include the load.
                from repro_torch.evalsuite import hostcell

                ds_rows.extend(
                    hostcell.run_cell(spec, m, seed, data_root=data_root,
                                      verbose=verbose, device=dev)
                    for seed in seeds)
                continue
            # Warm-up: one untimed fit per (dataset, method) cell so the
            # timed rows measure steady state, not first-use costs.
            _run_cell(spec, m, seeds[0], source, X, verbose=False,
                      device=dev, rng=rng)
            ds_rows.extend(_run_cell(spec, m, seed, source, X, verbose,
                                     device=dev, rng=rng)
                           for seed in seeds)

        # ε needs f*: the committed best-known value, or — during
        # bootstrap, before one is committed — the best f of this very
        # run (recorded as such in the artifact).
        record = spec.to_record()
        if spec.f_star is None:
            record["f_star"] = min(r["f_full"] for r in ds_rows)
            record["f_star_source"] = "run-best (uncommitted bootstrap)"
        else:
            record["f_star_source"] = "committed"
        for r in ds_rows:
            r["epsilon"] = metrics.relative_error(r["f_full"],
                                                  record["f_star"])
            r["success"] = r["epsilon"] <= success_tol
        dataset_records.append(record)
        rows.extend(ds_rows)

    cells = [
        metrics.aggregate_cell(
            spec.name, m.name, m.kind,
            [r for r in rows
             if r["dataset"] == spec.name and r["method"] == m.name],
            success_tol=success_tol)
        for spec in specs for m in methods
    ]
    doc = schema.envelope(
        "suite", rows,
        host=schema.host_info(dev),
        tier=tier,
        seeds=list(seeds),
        success_tol=success_tol,
        protocol=PROTOCOL,
        datasets=dataset_records,
        cells=cells,
    )
    schema.check(doc, schema.SUITE_SCHEMA, what="BENCH_suite document")
    return doc


def write_outputs(doc: dict, json_path: str, csv_path: str | None = None
                  ) -> None:
    """Validate + write the suite artifact (and the per-run CSV)."""
    schema.write_bench(json_path, doc, schema.SUITE_SCHEMA)
    if csv_path:
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        cols = ["dataset", "method", "kind", "seed", "f_full", "epsilon",
                "success", "wall_s", "n_chunks", "n_iterations",
                "n_accepted", "strategy"]
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for r in doc["rows"]:
                w.writerow([r.get(c, "") for c in cols])
