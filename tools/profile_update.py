#!/usr/bin/env python3
"""Device time of each launch of the update kernels C, C16, C3 and C8.

    python3 tools/profile_update.py

Each kernel is two launches, a tile pass and a reduce
(``src/repro_torch/kernels/csrc/update.cuh``).  At the main path's shape
(m = 64,000, k = 25, n = 28) and at the two-pass route's (s = 16,384,
k = 2,048, n = 1,024), on x and ids generated on the card from fixed seeds,
this prints one JSON line per shape: each kernel's device µs per call by
CUDA-graph replay, and each of its launches' device µs per call from
``torch.profiler`` (CUDA activity).  Needs a CUDA card (sm_90).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import precision as px  # noqa: E402
from repro_torch.kernels import update  # noqa: E402

SHAPES = [(64_000, 25, 28), (16_384, 2048, 1024)]   # (m, k, n)


def graph_us(fn, launches: int = 20, replays: int = 5) -> float:
    """Device µs per call: CUDA events around replays of a CUDA graph
    holding ``launches`` back-to-back calls (warm)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop) / (launches * replays)


def launch_us(fn, calls: int = 20) -> dict:
    """Device µs per call of each kernel ``fn`` launches (torch.profiler)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls
            for e in prof.key_averages() if "update" in e.key}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_update: no CUDA device", file=sys.stderr)
        return 1
    build.load()
    for m, k, n in SHAPES:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(m + k + n)
        x = torch.randn((m, n), generator=gen, device="cuda") * 3.0
        ids = torch.randint(0, k, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
        xb = x.bfloat16()
        q = px.quantize_chunk(x).q
        calls = {"C": lambda: update.update_f32(x, ids, k),
                 "C16": lambda: update.update_16(xb, ids, k, "bf16"),
                 "C3": lambda: update.update_16(x, ids, k, "bf16x3"),
                 "C8": lambda: update.launch_update_int8(q, ids, k)}
        print(json.dumps({"m": m, "k": k, "n": n, "kernels": {
            name: {"us": graph_us(fn), "launches_us": launch_us(fn)}
            for name, fn in calls.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
