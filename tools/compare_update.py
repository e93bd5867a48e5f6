#!/usr/bin/env python3
"""Hold this checkout's update kernels and two-pass fits to another tree's.

    python3 tools/compare_update.py --against DIR

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Each tree
runs, in a process of its own and with its own kernel library:

* kernels C, C16, C3 and C8 (``update.update_f32``, ``update_16``,
  ``launch_update_int8``) at the main path's shape (m = 64,000, k = 25,
  n = 28) and at the two-pass route's (s = 16,384, k = 2,048, n = 1,024),
  on x and ids generated on the card from fixed seeds: their outputs, and
  their device time per launch (CUDA events over CUDA-graph replays);
* ``chip_smoke.py``'s two-pass route: a 2,048-component mixture of
  1,048,576 rows 1,024 wide generated on the card, and a sequential
  ``fit`` (k = 2,048, s = 16,384, 4 chunks: outside the fused envelope,
  so every Lloyd iteration runs kernels B and C at the policy) and
  ``evaluate`` under each policy — f32, int8, bf16 and bf16x3 — untuned:
  the trace (chunk, objective, accept), the centroids, the chunk
  objective, the iteration count, the full-data objective and assignment,
  and the wall of ``fit`` + ``evaluate`` (kernels built beforehand, after
  one warm-up fit).

The trees run in turns (other, this, this, other).  Every output is
compared bit for bit between the trees and between each tree's two runs;
the times and walls are printed beside the verdict as one JSON line.
Exits 1 if any output differs.  Needs a CUDA card (sm_90).
``--dump SRC OUT`` is the per-tree step.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("f32", "int8", "bf16", "bf16x3")


SHAPES = {"main": (64_000, 25, 28), "two_pass": (16_384, 2048, 1024)}


def device_us(fn, launches: int = 20, replays: int = 5) -> float:
    """Device µs per call: CUDA events around replays of a CUDA graph
    holding ``launches`` back-to-back calls (warm)."""
    import torch

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
    us = 1e3 * start.elapsed_time(stop) / (launches * replays)
    del graph
    torch.cuda.empty_cache()
    return us


def dump(src: str, out: str) -> None:
    """Run the update kernels and the two-pass fits of the package under
    ``src``; save their outputs, times and walls to ``out``."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.api import BigMeansConfig, evaluate, fit
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import autotune, build, update
    from repro_torch.kernels import precision as px

    autotune.enable(False)
    autotune.set_cache_path(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    results, times, walls = {}, {}, {}
    for where, (m, k, n) in SHAPES.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(m + k + n)
        x = torch.randn((m, n), generator=gen, device="cuda") * 3.0
        ids = torch.randint(0, k, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids[::97] = -1
        xb = x.bfloat16()
        q = px.quantize_chunk(x).q
        calls = {"C": lambda: update.update_f32(x, ids, k),
                 "C16": lambda: update.update_16(xb, ids, k, "bf16"),
                 "C3": lambda: update.update_16(x, ids, k, "bf16x3"),
                 "C8": lambda: update.launch_update_int8(q, ids, k)}
        for name, call in calls.items():
            results[f"{name} {where}"] = tuple(t.cpu() for t in call())
            times[f"{name} {where}"] = device_us(call)
        del x, xb, q
        torch.cuda.empty_cache()
    X = gmm_dataset(GMMSpec(m=1 << 20, n=1024, components=2048, seed=0),
                    device="cuda")
    fit(X, BigMeansConfig(k=2048, s=16_384, n_chunks=1, seed=1),
        method="sequential")                                  # warm-up
    for prec in POLICIES:
        cfg = BigMeansConfig(k=2048, s=16_384, n_chunks=4, seed=0,
                             precision=prec)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = fit(X, cfg, method="sequential")
        ids, f_full = evaluate(res, X)
        torch.cuda.synchronize()
        walls[prec] = time.monotonic() - t0
        results[f"fit {prec}"] = {
            "trace": [(int(i), float(f).hex(), bool(a))
                      for i, f, a in res.trace],
            "centroids": res.centroids.cpu(),
            "objective": float(res.objective).hex(),
            "n_iterations": int(res.n_iterations),
            "f_full": float(f_full).hex(),
            "ids": ids.cpu()}
    torch.save({"results": results, "times_us": times, "walls_s": walls},
               out)


def same(a, b) -> bool:
    """Bitwise equality of saved outputs (tensors compared by their
    bytes)."""
    import torch

    if isinstance(a, (tuple, list)) and a and isinstance(a[0],
                                                          torch.Tensor):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))
    return a == b


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="the other tree's root")
    parser.add_argument("--dump", nargs=2, metavar=("SRC", "OUT"))
    args = parser.parse_args()
    if args.dump:
        dump(*args.dump)
        return 0
    if not args.against:
        parser.error("--against DIR or --dump SRC OUT is needed")
    import torch

    outdir = ROOT / "build" / "compare_update"
    outdir.mkdir(parents=True, exist_ok=True)
    env = {key: val for key, val in os.environ.items()
           if not key.startswith("REPRO_AUTOTUNE")}
    trees = {"other": Path(args.against).resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for i, name in enumerate(("other", "this", "this", "other")):
        out = outdir / f"{name}_{i}.pt"
        subprocess.run([sys.executable, __file__, "--dump",
                        str(trees[name] / "src"), str(out)], check=True,
                       env=env)
        runs[name].append(torch.load(out))
    other, this = runs["other"][0]["results"], runs["this"][0]["results"]
    differ = sorted(key for key in other
                    if key not in this or not same(other[key], this[key]))
    repeat = all(same(r[0]["results"], r[1]["results"])
                 for r in runs.values())
    print(json.dumps({"compare_update": {
        "against": args.against, "outputs": len(other), "differ": differ,
        "each_tree_repeats_bitwise": repeat,
        "iterations": {p: this[f"fit {p}"]["n_iterations"]
                       for p in POLICIES},
        "times_us_in_turns": {name: [r["times_us"] for r in rs]
                              for name, rs in runs.items()},
        "walls_s_in_turns": {name: [r["walls_s"] for r in rs]
                             for name, rs in runs.items()}}}), flush=True)
    return 1 if differ or not repeat else 0


if __name__ == "__main__":
    sys.exit(main())
