"""One run of one cell (see ``run.py``)."""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

from perfbench import cells, hostinfo

ROOT = Path(__file__).resolve().parents[1]
PROFILE = ROOT / "results" / "autotune" / "cuda-sm_90.json"


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def err(*lines) -> None:
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def card_check(chips: int) -> str | None:
    """Why the run cannot go on this machine, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs only on the card"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, this machine has "
                f"{torch.cuda.device_count()}")
    return None


def prepare_program(device) -> None:
    """Load the port's kernels and fix how it runs: float32 products
    without TF32, as the configurations state, and the committed tuner
    profile pinned (read, never tuned or written)."""
    import torch
    from repro_torch.kernels import autotune, build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    autotune.enable(False)
    autotune.set_cache_path(PROFILE)
    if device.type == "cuda":
        build.load()


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, loop_cls=None, phases=None) -> dict:
    """Set up, warm up, run the window, trace, judge: the run's record,
    the judged numbers and the raw outputs of the result line.  The caller
    has checked the card (or asked for the CPU)."""
    import torch

    from perfbench import devtrace, loops

    phases = dict(phases or {})
    phases["imports"] = time.monotonic() - t_start
    prepare_program(device)
    phases["kernels"] = time.monotonic() - t_start
    cls = loop_cls or loops.find(cell["mix"]["loop"])
    loop = cls(cell["config"], cell["mix"], seed, device)
    loops.sync(device)
    phases["data"] = time.monotonic() - t_start
    loop.warm()
    loops.sync(device)
    setup_s = time.monotonic() - t_start
    phases["warm-up"] = setup_s

    sampler = hostinfo.Sampler() if device.type == "cuda" else None
    try:
        jobs, window_s = loop.window(seconds)
    finally:
        samples = sampler.stop() if sampler else []
    traced = None
    if trace:
        t0 = time.monotonic()
        traced_jobs, reduction = devtrace.traced(
            loop, cell["mix"]["trace_seconds"], jobs)
        traced = {"jobs": traced_jobs, **reduction}
        phases["traced (after the window)"] = time.monotonic() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = loop.judge()
    f_true = loop.denominator()
    if f_true is not None:
        from perfbench.reference import judge

        numbers.update(judge.denominator_rel(loop.X, loop.means, f_true))
    run = {"cell": cell["name"], "config": cell["config"],
           "mix": cell["mix"], "setup_s": setup_s,
           "window": {"seconds": window_s, "jobs": jobs},
           "f_true": f_true, "traced": traced}
    host = sampler.lines(samples) if sampler else []
    host.append("# set-up ends (s from start): " + ", ".join(
        f"{name} {t:.3f}" for name, t in phases.items()))
    host.append(f"# window: {len(jobs)} jobs in {window_s:.4f} s; " + ", ".join(
        f"mean {key} {sum(j[key] for j in jobs) / len(jobs):.6g}"
        for key in jobs[0] if key not in ("seed", "f")))
    key = "fit_s" if "fit_s" in jobs[0] else "evaluate_s"
    times = sorted(j[key] for j in jobs)
    host.append(f"# {key} a job: min {times[0]:.6g}, median "
                f"{times[len(times) // 2]:.6g}, max {times[-1]:.6g}")
    if traced:
        tj = traced["jobs"]
        host.append(
            f"# traced (device-only profiler): {len(tj)} jobs in "
            f"{traced['window_s']:.6g} s ({traced['untraced_s']:.6g} s "
            f"untraced), busy {traced['busy_s']:.6g} s; "
            f"mean {key} {sum(j[key] for j in tj) / len(tj):.6g} against "
            f"the window's {sum(times) / len(times):.6g}")
    return {"run": run, "numbers": numbers, "peak": peak,
            "attempted": loop.count, "host": host}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct iff every limit holds."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def result_line(cell: dict, out: dict, trace: bool, device) -> dict:
    import torch

    run = out["run"]
    ok, checks = verdict(out["numbers"], cell["limits"])
    metrics = cells.read_metrics(
        cell["per_layer"] if trace else cell["end_to_end"], run)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(out["peak"])}
    line = {"correct": ok, "attempted": out["attempted"], "failed": 0,
            "metrics": metrics, "device": dev}
    if trace:
        tr = run["traced"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv, *, t_start: float) -> int:
    args = parse(argv)
    cell = cells.load_cell(args.workload)
    import torch

    phases = {"torch import": time.monotonic() - t_start}
    why = card_check(cell["chips"])
    phases["card check"] = time.monotonic() - t_start
    if why:
        err(f"perfbench: {why}")
        return 3
    device = torch.device("cuda", 0)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                  t_start, phases=phases)
    line = result_line(cell, out, bool(args.trace), device)
    for text in out["host"]:
        print(text, flush=True)
    found = hostinfo.forbidden_modules()
    if found:
        err(f"perfbench: modules of JAX or the JAX package were loaded: "
            f"{found}")
        return 4
    err(*(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
          for name, c in line["checks"].items()))
    print(json.dumps(line), flush=True)
    return 0
