"""The program's spans and counters read by ``perfbench/progtrace.py``:
its readings, and a replay on the CPU at a small size that leaves the
judged sample and the run's readings as they were."""
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import cells, control, harness, loops, progtrace

ROOT = Path(__file__).resolve().parents[2]


def _program():
    span = {"count": 1, "host_ms": 9.0, "self_device_ms": 1.0,
            "parents": [None]}
    return {"record": {}, "job_s": 4.0,
            "spans": {"core.kmeanspp.seed": {**span, "device_ms": 2500.0},
                      "core.kmeans.lloyd": {**span, "device_ms": 1400.0},
                      "api.evaluate": {**span, "device_ms": 103.0},
                      "api.fit": {**span, "device_ms": 4000.0}},
            "counters": {"host_sync.core.kmeanspp.pick": 8192,
                         "host_sync.core.kmeans.stop": 41,
                         "host_sync.api.evaluate": 1, "other": 7}}


def test_readings_are_none_without_a_replay():
    assert progtrace.readings(None) == dict.fromkeys(progtrace.READINGS)


def test_readings_of_a_replay():
    assert progtrace.readings(_program()) == {
        "seed_ms.fit": 2500.0, "lloyd_ms.fit": 1400.0,
        "evaluate_dev_ms.fit": 103.0, "host_syncs_per_job.fit": 8234}
    cpu = _program()
    cpu["spans"]["core.kmeanspp.seed"]["device_ms"] = None
    del cpu["spans"]["core.kmeans.lloyd"]
    got = progtrace.readings(cpu)
    assert got["seed_ms.fit"] is None and got["lloyd_ms.fit"] is None


def _window(cell_name: str):
    """A short window of ``cell_name`` on the CPU at the control's size:
    (the loop, the run's output)."""
    cell = cells.load_cell(cell_name)
    cell["config"].update(control.SHRINK)
    made = []

    class Kept(loops.find(cell["mix"]["loop"])):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    out = harness.execute(cell, 2**31 + 77, 0.3, False, torch.device("cpu"),
                          time.monotonic(), loop_cls=Kept)
    return cell, made[0], out


@pytest.mark.parametrize("cell_name", ["codebook.fit", "codebook.encode"])
def test_a_replay_records_the_program_and_leaves_the_run_as_it_was(
        cell_name):
    cell, loop, out = _window(cell_name)
    sample = loop.sample
    before = (list(sample.items), sample.seen, sample._rand.getstate(),
              loop.count)
    metrics = cells.read_metrics(cell["end_to_end"] + cell["per_layer"],
                                 out["run"])
    judged = loop.judge()
    program = progtrace.replay(loop)
    assert set(program) == {"record", "job_s", "spans", "counters"}
    assert "api.evaluate" in program["spans"]
    if cell_name == "codebook.fit":
        assert {"api.fit", "core.kmeanspp.seed", "core.kmeans.lloyd",
                "core.kmeans.epilogue"} <= set(program["spans"])
        assert program["record"]["seed"] == out["run"]["window"]["jobs"][0][
            "seed"]
        got = progtrace.readings(program)
        assert got["host_syncs_per_job.fit"] == sum(
            v for k, v in program["counters"].items()
            if k.startswith("host_sync."))
        assert program["counters"]["host_sync.core.kmeans.stop"] == \
            program["record"]["n_iterations"]
    pairs = progtrace.cost_pairs(loop, 1)
    assert len(pairs) == 1 and min(pairs[0]) > 0.0
    after = (list(sample.items), sample.seen, sample._rand.getstate(),
             loop.count)
    assert after[1:] == before[1:]
    assert all(a is b for a, b in zip(after[0], before[0]))
    assert len(after[0]) == len(before[0])
    assert cells.read_metrics(cell["end_to_end"] + cell["per_layer"],
                              out["run"]) == metrics
    assert loop.judge() == judged
    from repro_torch import tracing

    assert not tracing.enabled()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_a_program_without_tracing_records_nothing(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert progtrace.replay(object()) is None


def test_progtrace_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "perfbench/progtrace.py", "--workload",
         "codebook.fit", "--seed", "5", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
