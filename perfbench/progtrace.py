"""The program's own spans and host-sync counters in one cell, on the card.

    python3 perfbench/progtrace.py --workload codebook.fit --seed 7 \
        --seconds 51 --pairs 3

Runs the cell as ``perfbench/run.py --trace 1`` does (set-up, the timed
window, the two profiled passes of ``devtrace``, the judge), replays the
window's first job once untraced (the run emptied the allocator's cache
after its profiled passes), then once more, seed for seed, with
``repro_torch.tracing`` on and no profiler (:func:`replay`), and
``--pairs`` times more with tracing off and on in turns, to time what
tracing costs when on.  It prints ``#`` lines (the replay's time against
the window's job 0, then each span and counter), and last run.py's result
line with ``"program"`` (the replay: ``record``, ``job_s``, ``spans``,
``counters``) and ``"readings"`` (:data:`READINGS`) added.

The judged sample and the loop's job count are left as they were, so the
result line's own numbers are those of ``run.py --trace 1``.  Without a
``repro_torch.tracing`` module the replay records nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the per-layer readings of one replayed job: (span, its device ms) or,
# for host syncs, the sum of the ``host_sync.*`` counters
READINGS = {
    "seed_ms.fit": "core.kmeanspp.seed",
    "lloyd_ms.fit": "core.kmeans.lloyd",
    "evaluate_dev_ms.fit": "api.evaluate",
    "host_syncs_per_job.fit": "host_sync.",
}


@contextlib.contextmanager
def untouched(loop):
    """Run jobs of ``loop`` and leave its judged sample (items, ``seen``,
    the draw's state) and its job count as they were."""
    sample = loop.sample
    kept = (list(sample.items), sample.seen, sample._rand.getstate(),
            loop.count)
    try:
        yield
    finally:
        sample.items[:] = kept[0]
        sample.seen = kept[1]
        sample._rand.setstate(kept[2])
        loop.count = kept[3]


def _timed_job(loop) -> tuple[dict, float]:
    from perfbench import loops

    loops.sync(loop.device)
    t0 = time.monotonic()
    record = loop.replay(0)
    loops.sync(loop.device)
    return record, time.monotonic() - t0


def replay(loop) -> dict | None:
    """Job 0 of the window again with the program's tracing on: ``{"record",
    "job_s", "spans", "counters"}`` (:func:`repro_torch.tracing.snapshot`),
    or None for a program without tracing."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    with untouched(loop):
        tracing.snapshot()
        tracing.enable(True)
        try:
            record, job_s = _timed_job(loop)
        finally:
            tracing.enable(False)
        snap = tracing.snapshot()
    return {"record": record, "job_s": job_s, **snap}


def cost_pairs(loop, pairs: int) -> list[tuple[float, float]]:
    """``pairs`` × (job 0 with tracing off, then on): host seconds each."""
    from repro_torch import tracing

    out = []
    with untouched(loop):
        for _ in range(pairs):
            off = _timed_job(loop)[1]
            tracing.enable(True)
            try:
                on = _timed_job(loop)[1]
            finally:
                tracing.enable(False)
            tracing.snapshot()
            out.append((off, on))
    return out


def readings(program: dict | None) -> dict:
    """:data:`READINGS` of one replayed job: None where there is nothing to
    read (no replay, or a span that ran on the CPU)."""
    if not program:
        return dict.fromkeys(READINGS)
    out = {}
    for name, what in READINGS.items():
        if what.endswith("."):
            out[name] = sum(v for k, v in program["counters"].items()
                            if k.startswith(what))
        else:
            out[name] = program["spans"].get(what, {}).get("device_ms")
    return out


def host_lines(program: dict, window_job_s: float, pairs: list) -> list:
    rel = 100 * (program["job_s"] / window_job_s - 1)
    lines = [f"# program replay of job 0 with tracing on: "
             f"{program['job_s']:.6g} s against the window's "
             f"{window_job_s:.6g} s ({rel:+.2f} %)"]
    for off, on in pairs:
        lines.append(f"# job 0 tracing off {off:.6g} s, on {on:.6g} s "
                     f"({100 * (on / off - 1):+.2f} %)")
    for name, s in program["spans"].items():
        dev = ("-" if s["device_ms"] is None else
               f"{s['device_ms']:.6g} ms (self {s['self_device_ms']:.6g})")
        lines.append(f"# span {name}: {s['count']} calls, host "
                     f"{s['host_ms']:.6g} ms, device {dev}, in "
                     f"{','.join(str(p) for p in s['parents'])}")
    for name, n in sorted(program["counters"].items()):
        lines.append(f"# counter {name}: {n}")
    return lines


def main(argv, *, t_start: float) -> int:
    from perfbench import cells, harness, hostinfo, loops

    ap = argparse.ArgumentParser(prog="perfbench/progtrace.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    import torch

    why = harness.card_check(cell["chips"])
    if why:
        harness.err(f"progtrace: {why}")
        return 3
    device = torch.device("cuda", 0)
    made = []

    class Kept(loops.find(cell["mix"]["loop"])):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    out = harness.execute(cell, args.seed, args.seconds, True, device,
                          t_start, loop_cls=Kept)
    line = harness.result_line(cell, out, True, device)
    loop = made[0]
    with untouched(loop):
        _timed_job(loop)    # refills the allocator's cache execute emptied
    program = replay(loop)
    if program is not None:
        pairs = cost_pairs(loop, args.pairs)
        out["host"] += host_lines(
            program, out["run"]["window"]["jobs"][0]["job_s"], pairs)
        line["program"] = program
        line["readings"] = readings(program)
    for text in out["host"]:
        print(text, flush=True)
    found = hostinfo.forbidden_modules()
    if found:
        harness.err(f"progtrace: modules of JAX or the JAX package were "
                    f"loaded: {found}")
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    T_START = time.monotonic()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(
        ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if sys.path[2:3] == [str(ROOT / "perfbench")]:
        del sys.path[2]
    sys.exit(main(sys.argv[1:], t_start=T_START))
