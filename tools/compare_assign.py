#!/usr/bin/env python3
"""Time this checkout's assign kernels and two-pass fits against another
tree's, in turns on one card.

    python3 tools/compare_assign.py --against DIR

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Each tree
runs, in a process of its own and with its own kernel library:

* kernels B (``distance.assign_f32``), B3 (``distance.assign_16`` at
  ``"bf16x3"``), B8 (``distance.launch_assign_int8`` on prepared
  operands) and B16 (``distance.assign_16`` on a bf16 chunk) at the main
  path's shape (m = 64,000, k = 25, n = 28) and at the two-pass route's
  (s = 16,384, k = 2,048, n = 1,024), on inputs generated on the card from
  fixed seeds: their outputs and their device time per call (CUDA events
  over CUDA-graph replays, ``compare_update.device_us``);
* ``chip_smoke.py``'s two-pass route under each policy — f32, int8, bf16
  and bf16x3 — a sequential ``fit`` (k = 2,048, s = 16,384, 4 chunks)
  and ``evaluate``, untuned, after one warm-up fit, twice: the trace,
  centroids, iterations and full-data objective, and the walls of ``fit``
  + ``evaluate``.

The trees run in turns (other, this, this, other, other, this): six walls
a policy and tree, the host's clock moving by tenths of a second between
fits.  Each tree's runs must agree bit for bit (exit 1 otherwise); between
the trees the outputs
are compared and the ones that differ listed, not failed on: a change to
the kernels' arithmetic (B16's order of sums, the norms' order) parts the
trajectories at near ties.  Prints one JSON line with the verdicts, the
iterations, the kernel times and the walls.  Needs a CUDA card (sm_90).
``--dump SRC OUT`` is the per-tree step.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from compare_update import POLICIES, SHAPES, device_us, same  # noqa: E402


def dump(src: str, out: str) -> None:
    """Run B, B3, B8, B16 and the two-pass fits of the package under ``src``;
    save their outputs, times and walls to ``out``."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.api import BigMeansConfig, evaluate, fit
    from repro_torch.data.synthetic import GMMSpec, gmm_dataset
    from repro_torch.kernels import autotune, build, distance
    from repro_torch.kernels import precision as px

    autotune.enable(False)
    autotune.set_cache_path(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    results, times, walls = {}, {}, {}
    for where, (m, k, n) in SHAPES.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(m + k + n)
        c = torch.randn((k, n), generator=gen, device="cuda") * 5.0
        comp = torch.randint(0, k, (m,), generator=gen, device="cuda")
        x = (c[comp] + torch.randn((m, n), generator=gen, device="cuda")
             ).contiguous()
        qx = px.quantize_chunk(x)
        cq, t = px.quantize_centroids(c, qx.scale)
        xb = x.bfloat16()
        calls = {"B": lambda: distance.assign_f32(x, c),
                 "B3": lambda: distance.assign_16(x, c, "bf16x3"),
                 "B8": lambda: distance.launch_assign_int8(qx.q, qx.scale,
                                                           cq, t, c),
                 "B16": lambda: distance.assign_16(xb, c, "bf16")}
        for name, call in calls.items():
            results[f"{name} {where}"] = tuple(a.cpu() for a in call())
            times[f"{name} {where}"] = device_us(call)
        del x, xb, qx
        torch.cuda.empty_cache()
    X = gmm_dataset(GMMSpec(m=1 << 20, n=1024, components=2048, seed=0),
                    device="cuda")
    fit(X, BigMeansConfig(k=2048, s=16_384, n_chunks=1, seed=1),
        method="sequential")                                  # warm-up
    for prec in POLICIES:
        cfg = BigMeansConfig(k=2048, s=16_384, n_chunks=4, seed=0,
                             precision=prec)
        walls[prec] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = fit(X, cfg, method="sequential")
            ids, f_full = evaluate(res, X)
            torch.cuda.synchronize()
            walls[prec].append(time.monotonic() - t0)
        results[f"fit {prec}"] = {
            "trace": [(int(i), float(f).hex(), bool(a))
                      for i, f, a in res.trace],
            "centroids": res.centroids.cpu(),
            "n_iterations": int(res.n_iterations),
            "f_full": float(f_full).hex(),
            "ids": ids.cpu()}
    torch.save({"results": results, "times_us": times, "walls_s": walls},
               out)


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

    outdir = ROOT / "build" / "compare_assign"
    outdir.mkdir(parents=True, exist_ok=True)
    env = {key: val for key, val in os.environ.items()
           if not key.startswith("REPRO_AUTOTUNE")}
    trees = {"other": Path(args.against).resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for i, name in enumerate(("other", "this", "this", "other", "other",
                              "this")):
        out = outdir / f"{name}_{i}.pt"
        subprocess.run([sys.executable, __file__, "--dump",
                        str(trees[name] / "src"), str(out)], check=True,
                       env=env)
        runs[name].append(torch.load(out))
    other, this = runs["other"][0]["results"], runs["this"][0]["results"]
    differ = sorted(key for key in other
                    if key not in this or not same(other[key], this[key]))
    repeat = {name: all(same(r[0]["results"], x["results"]) for x in r[1:])
              for name, r in runs.items()}
    print(json.dumps({"compare_assign": {
        "against": args.against, "outputs": len(other),
        "differ_between_trees": differ,
        "each_tree_repeats_bitwise": repeat,
        "iterations": {name: {p: r[0]["results"][f"fit {p}"]["n_iterations"]
                              for p in POLICIES}
                       for name, r in runs.items()},
        "times_us_in_turns": {name: [r["times_us"] for r in rs]
                              for name, rs in runs.items()},
        "walls_s_in_turns": {name: [r["walls_s"] for r in rs]
                             for name, rs in runs.items()},
        "median_wall_s": {name: {p: statistics.median(
            w for r in rs for w in r["walls_s"][p]) for p in POLICIES}
            for name, rs in runs.items()}}}), flush=True)
    return 0 if all(repeat.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
