"""BENCHMARK.json against the benchmark's contract, and every piece a cell
names found by name."""
import json
import re
from pathlib import Path

import pytest

from perfbench import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_the_budget():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in BENCH["configs"]]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [w["config"] for w in BENCH["workloads"]])
def test_names_are_of_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert (ROOT / "perfbench" / "metrics" / f"{metric['name']}.py").is_file()
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in \
            metric["layer"]
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_names_are_unique():
    for group in ([m["name"] for m in METRICS], CELLS,
                  [c["name"] for c in BENCH["configs"]],
                  [(w["config"], w["traffic"]) for w in BENCH["workloads"]]):
        assert len(group) == len(set(group))


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metrics_cells_report_what_it_moves(metric):
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = cells.load_cell(cell)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    assert c["chips"] == 1
    assert c["limits"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / config["file"]
    assert config["file"].startswith("perfbench/") and path.is_file()
    data = json.loads(path.read_text())
    assert data["reduced"] == config["reduced"]
    assert data["precision"] == "f32"
    for key in ("m", "n", "k", "s", "n_chunks"):
        assert isinstance(data[key], int) and data[key] > 0


@pytest.mark.parametrize("text", [w["why"] for w in BENCH["workloads"]]
                         + [c["why"] for c in BENCH["configs"]]
                         + [c["source"] for c in BENCH["configs"]])
def test_free_text_is_one_short_line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
