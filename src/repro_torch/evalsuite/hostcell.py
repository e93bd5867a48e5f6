"""The multi-host suite cell: a 2-process ``host_mesh`` run as one row.

The reference's ``repro.evalsuite.hostcell``.  In-process cells call
:func:`repro_torch.api.fit` directly; a ``host_mesh`` cell wants one OS
process per rank, so this module is both sides of that boundary:

* :func:`run_cell` (parent) — launches ``hosts`` copies of this module's
  CLI via :func:`repro_torch.engine.hostmesh.launch_local`, checks that
  every rank finished and that the ranks agree on ``f_best``, and folds
  the per-rank reports into one suite row (schema ``_ROW_SCHEMA``, minus
  ε, which the suite runner owns).
* ``python -m repro_torch.evalsuite.hostcell`` (child, one per rank) —
  rebuilds the dataset from the registry, fits with
  ``topology='host_mesh'`` (bootstrap read from the ``REPRO_*``
  environment the launcher set) on ``--device``, and prints a single
  ``RESULT {...}`` JSON line.

Wall time per row is the slowest rank's ``fit()`` wall — the fleet is as
slow as its slowest member — and each rank is a new process, so it
includes the kernels' load at first use.  A child exits normally: rank 0
waits in ``HostRuntime.leave`` until its peers have read the final
gather, so no rank loses the store mid-read (the reference ends its
children with ``os._exit`` to skip ``jax.distributed``'s teardown; there
is none here).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch import device as devices
from repro_torch.evalsuite import datasets as ds

DEFAULT_TIMEOUT_S = 420.0
# src/, so that the children import this package wherever they start
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cell(spec, m, seed: int, *, data_root: str | None = None,
             verbose: bool = True, timeout_s: float = DEFAULT_TIMEOUT_S,
             device=None) -> dict:
    """One (dataset, seed) run of the multi-host cell ``m`` on ``device``
    (the card unless ``"cpu"``); returns the suite row.  Any rank failing
    — or ranks disagreeing on the incumbent — raises, so a broken exchange
    can never masquerade as a slow cell."""
    from repro_torch.engine.hostmesh import launch_local

    dev = devices.resolve(device)
    overrides = dict(m.overrides)
    hosts = int(overrides.pop("hosts", 2))
    # Materialize the memmap once up front so the ranks share the file
    # instead of racing to generate it.
    ds.materialize(spec, data_root)
    argv = [sys.executable, "-m", "repro_torch.evalsuite.hostcell",
            "--dataset", spec.name, "--seed", str(seed),
            "--overrides", json.dumps(overrides), "--device", dev.type]
    if data_root:
        argv += ["--data-root", data_root]
    path = os.environ.get("PYTHONPATH")
    env = {"PYTHONPATH": _SRC + (os.pathsep + path if path else "")}
    procs = launch_local(argv, hosts, timeout_s=timeout_s, env_extra=env)

    reports = {}
    for p in procs:
        line = next((ln for ln in p.output.splitlines()
                     if ln.startswith("RESULT ")), None)
        if p.returncode != 0 or line is None:
            tail = "\n".join(p.output.splitlines()[-15:])
            raise RuntimeError(
                f"hostcell rank {p.rank} failed (rc={p.returncode}) on "
                f"{spec.name} seed {seed}:\n{tail}")
        reports[p.rank] = json.loads(line[len("RESULT "):])
    objectives = {r["objective"] for r in reports.values()}
    if len(objectives) != 1:
        raise RuntimeError(
            f"hostcell ranks disagree on f_best after final exchange: "
            f"{sorted(objectives)} ({spec.name} seed {seed})")

    r0 = reports[0]
    row = {
        "dataset": spec.name,
        "method": m.name,
        "kind": m.kind,
        "seed": seed,
        "f_full": float(r0["f_full"]),
        "f_native": float(r0["objective"]),
        "wall_s": max(float(r["wall_time_s"]) for r in reports.values()),
        "n_chunks": int(r0["n_chunks"]),
        "n_iterations": int(r0["n_iterations"]),
        "n_accepted": int(r0["n_accepted"]),
        "strategy": r0["strategy"],
        "fit": dict(r0["fit"] or {}, hosts=hosts),
    }
    if verbose:
        print(f"[suite] {spec.name:14s} {m.name:22s} seed={seed} "
              f"f={row['f_full']:.5e}  wall={row['wall_s']:6.2f}s "
              f"({hosts} procs)", flush=True)
    return row


def _rank_main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--sync-timeout-s", type=float, default=60.0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)

    from repro_torch.api import BigMeansConfig, TopologySpec, evaluate, fit

    spec = ds.get_dataset(args.dataset)
    cfg = BigMeansConfig(
        k=spec.k, s=spec.s, n_chunks=spec.n_chunks, seed=args.seed,
        log_every=0,
        topology=TopologySpec(kind="host_mesh",
                              sync_timeout_s=args.sync_timeout_s),
        **json.loads(args.overrides))
    source = ds.source(spec, args.data_root)
    t0 = time.monotonic()
    result = fit(source, cfg, method="streaming", device=args.device)
    row = result.to_row()
    row["wall_time_s"] = time.monotonic() - t0
    host = result.extras.get("host", {})
    ranks = result.extras.get("health", {}).get("ranks", [])
    if ranks:   # fleet totals, not this rank's shard
        row["n_chunks"] = sum(int(h["chunks_done"]) for h in ranks)
    if host.get("rank", 0) == 0:
        _, f_full = evaluate(result, source.as_array(), device=args.device)
        row["f_full"] = float(f_full)
    print("RESULT " + json.dumps(row), flush=True)


if __name__ == "__main__":
    _rank_main()
