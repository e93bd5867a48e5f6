"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its mix file (``mixes/<traffic>.json``, which names
its loop, ``loops/<loop>.py``, found by ``perfbench.loops.find``), its
limits (``limits/<cell>.json``) and the readers of its metrics
(``metrics/<metric>.py``).  Nothing here names a cell: a new cell, mix,
loop or metric is a new file."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs, read from files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    cell = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "mixes" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"name": name, "chips": cell["chips"], "config": config,
            "mix": mix, "limits": limits, "end_to_end": end_to_end,
            "per_layer": per_layer}


def reader(metric: str):
    """The ``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: list[dict], run: dict) -> dict:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something to read in ``run``."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
