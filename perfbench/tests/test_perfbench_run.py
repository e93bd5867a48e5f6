"""A run without a card, the import check, and a run driven on the CPU at
a small size with the timed path broken underneath: each fault, and the
control, come out not correct; the sound program comes out correct."""
import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import cells, control, harness, hostinfo, loops

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return isinstance(json.loads(lines[-1]), dict)
    except ValueError:
        return False


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(["--workload", "codebook.fit", "--seed", "5", "--seconds",
                "1", "--trace", "0"], ROOT, env)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "no CUDA device" in out.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert hostinfo.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert hostinfo.forbidden_modules() == ["jax", "repro"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")
    if "tests" not in p.parts))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = _imports(HERE / path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    if path.split("/")[0] in ("reference", "gen", "metrics"):
        assert "repro_torch" not in names


def test_a_cpu_run_loads_no_jax_module():
    code = ("import sys, time; sys.path[:0] = ['src', '.'];"
            "import torch; from perfbench import cells, harness, hostinfo;"
            "cell = cells.load_cell('hepmass.fit');"
            "cell['config'].update(m=4096, n=4, k=5, s=512, n_chunks=2);"
            "harness.execute(cell, 3, 0.2, False, torch.device('cpu'),"
            " time.monotonic());"
            "print(hostinfo.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _drive(cell_name: str, name: str, seed: int = 2**31 + 101):
    """A run of ``cell_name`` on the CPU at the control's small size, with
    variant ``name`` (a fault, the control or the program) in place."""
    cell = cells.load_cell(cell_name)
    cell["config"].update(control.SHRINK)
    cls = control.variant(loops.find(cell["mix"]["loop"]), name)
    out = harness.execute(cell, seed, 0.3, False, torch.device("cpu"),
                          time.monotonic(), loop_cls=cls)
    line = harness.result_line(cell, out, False, torch.device("cpu"))
    return line


FIT_CELLS = ("codebook.fit", "hepmass.fit")


@pytest.mark.parametrize("cell", FIT_CELLS + ("codebook.encode",))
def test_the_sound_program_comes_out_correct(cell):
    line = _drive(cell, "program")
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in FIT_CELLS
    for f in ("fault_unchanged", "fault_half", "fault_id", "fault_accept")]
    + [("codebook.encode", "fault_id")])
def test_each_fault_comes_out_not_correct(cell, fault):
    assert not _drive(cell, fault)["correct"]


@pytest.mark.parametrize("cell", FIT_CELLS + ("codebook.encode",))
def test_the_control_comes_out_not_correct(cell):
    assert not _drive(cell, "plain_tf32")["correct"]


@pytest.mark.parametrize("cell", FIT_CELLS + ("codebook.encode",))
def test_the_plain_reference_at_f32_comes_out_correct(cell):
    line = _drive(cell, "plain_f32")
    checks = {k: v for k, v in line["checks"].items()
              if k != "denominator_rel"}
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["codebook.fit", "hepmass.fit",
                                  "codebook.encode"])
def test_a_short_run_on_the_card_is_correct(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run(["--workload", cell, "--seed", str(2**31 + 17), "--seconds",
                "3", "--trace", "0"], ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    # with only BENCHMARK.json and the files under paths, no result
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bare = _run(["--workload", cell, "--seed", "1", "--seconds", "1",
                 "--trace", "0"], tmp_path)
    assert bare.returncode != 0 and not _has_result(bare.stdout)
