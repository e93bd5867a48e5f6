#!/usr/bin/env python3
"""Device time of kernel P (the K-means++ candidate probe) beside its bound.

    python3 tools/profile_kpp.py [--against DIR]

At the four shapes P is timed at — the chunk seeding (m = 64,000, n = 28,
L = 3), one slot's probe of a seeding of all HEPMASS rows (m = 10,500,000,
n = 28, L = 3), the two-pass data's chunk seeding (m = 16,384,
n = 1,024, L = 3; ``src/repro/configs/seamless_m4t_medium.py:10``) and the
benchmark's codebook chunk seeding (m = 163,840, n = 768, L = 3) — on
points around well-separated centres generated on the card from fixed
seeds, three candidates drawn from the points and d the distances to a
fourth: the device µs per call of ``kpp_probe_cuda`` and of
``kpp_probe_plain`` by CUDA-graph replay, each launch's device µs from
``torch.profiler`` (CUDA activity), the bound (bytes read and written once
over 3.35 TB/s; the operations over 67 TFLOP/s fp32 are below it), and as a
yardstick of the card's read rate, ``x.sum()`` (one read of x) by graph
replay.  Where the tree has the seeding's slot kernels
(``kpp_probe.SlotChain``), also a whole K-means++ slot: the stream µs a
slot of 200 slots in a row (CUDA events; each slot's Gumbel noise drawn as
``seed`` draws it) and the host µs to issue one, for kernels G + P and for
the oracle chain's slot they replace (``core/kmeanspp.py``: the draw, then
``mm`` + ``minimum`` + ``sum`` and the pick); each kernel's device µs
(``launches_us``); the plain versions of G (``kpp_draw_plain``) and of
the probe chain alone (``pairwise_sqdist_ref`` + ``minimum`` + ``sum``) by
graph replay; and G's bound (noise, newd and d once over 3.35 TB/s).
Prints P's and G's ptxas registers, shared memory and spills.  Two more
shapes say what holds the small ones: one 256-row tile (m = 256: one
CTA's path from launch to pot) and the two-pass width at 132 tiles
(m = 33,792: one tile an SM).

``--against DIR`` times another tree too (for example the parent commit
unpacked with ``git archive`` into ``build/parent``): each tree in a
process of its own, in turns other, this, this, other.  Prints one JSON
line per turn, then one line with each shape's µs in both trees.  Needs a
CUDA card (sm_90).  ``--turn SRC`` is the per-tree step.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"seeding": (64_000, 28, 3), "full_data": (10_500_000, 28, 3),
          "two_pass_width": (16_384, 1024, 3),
          "codebook_seeding": (163_840, 768, 3)}   # (m, n, L)
# What holds the small shapes: one 256-row tile (a CTA's latency from
# launch to pot), and the two-pass width at 132 tiles (one an SM of the
# H100, where the two-pass width has 64)
DIAGNOSTIC = {"one_tile": (256, 28, 3),
              "two_pass_width_132_tiles": (33_792, 1024, 3)}
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def graph_us(fn, launches: int, replays: int = 5) -> float:
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


def launch_us(fn, calls: int) -> dict:
    """Device µs per call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls
            for e in prof.key_averages() if "kpp" in e.key}


def probe_inputs(m: int, n: int, L: int, seed: int):
    """x around 25 well-separated centres, L candidates drawn from x, d
    the distances to another row of x (as a K-means++ slot gives them)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = torch.randn((25, n), generator=gen, device="cuda") * 5.0
    comp = torch.randint(0, 25, (m,), generator=gen, device="cuda")
    x = c[comp]
    x += torch.randn((m, n), generator=gen, device="cuda")
    del comp
    idx = torch.randint(0, m, (L + 1,), generator=gen, device="cuda")
    d = ((x - x[idx[0]]) ** 2).sum(1)
    return x, x[idx[1:]].contiguous(), d


def slot_times(x, d, L: int, slots: int = 200) -> dict:
    """A K-means++ slot on kernels G + P and on the oracle chain (see the
    module docstring); {} for a tree without ``SlotChain``."""
    import time

    import torch

    from repro_torch import random as rnd
    from repro_torch.kernels import kpp_probe as kpp
    from repro_torch.kernels.ref import pairwise_sqdist_ref

    if not hasattr(kpp, "SlotChain"):
        return {}
    m, n = x.shape
    rng, dev = rnd.TORCH, x.device
    keys = rng.split(rng.key(m), slots)
    c = torch.zeros((2, n), device=dev)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)

    def kernels(dd):
        chain = kpp.SlotChain(x, dd, c, L)
        for j, k1 in enumerate(keys):
            chain.slot(rng.gumbel(k1, (L, m), dev), j % 2)
        chain.finish()

    def oracle(dd):
        for j, k1 in enumerate(keys):
            logits = torch.where(torch.sum(dd) > 0,
                                 torch.log(torch.clamp_min(dd, 1e-30)),
                                 torch.zeros_like(dd))
            noise = rng.gumbel(k1, (L, m), dev)
            cands = x[torch.argmax(noise + logits[None, :], dim=1)]
            newd = torch.minimum(dd[:, None],
                                 pairwise_sqdist_ref(x, cands, x2))
            b = torch.argmin(torch.sum(newd, dim=0), dim=0, keepdim=True)
            c[j % 2] = cands.index_select(0, b)[0]
            dd = newd.index_select(1, b)[:, 0]

    out = {}
    for name, loop in (("slot", kernels), ("oracle_slot", oracle)):
        loop(d.clone())                                  # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        dd = d.clone()
        start.record()
        t0 = time.perf_counter()
        loop(dd)
        host = time.perf_counter() - t0
        stop.record()
        torch.cuda.synchronize()
        out[f"{name}_stream_us"] = 1e3 * start.elapsed_time(stop) / slots
        out[f"{name}_host_us"] = 1e6 * host / slots
    noise = rng.gumbel(keys[0], (L, m), dev)
    cands = x[:L].contiguous()
    out["draw_plain_us"] = graph_us(lambda: kpp.kpp_draw_plain(x, noise, d),
                                    20)
    out["probe_chain_us"] = graph_us(lambda: torch.minimum(
        d[:, None], pairwise_sqdist_ref(x, cands, x2)).sum(0), 20)
    out["draw_bound_us"] = 1e6 * 4 * (2 * L * m + m + 2 * L * n) \
        / HBM_BYTES_PER_S
    out["slot_launches_us"] = launch_us(lambda: kernels(d.clone()), 1)
    for key in out["slot_launches_us"]:
        out["slot_launches_us"][key] /= slots
    return out


def turn(src: str) -> dict:
    """Time kernel P of the package under ``src`` at every shape."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import kpp_probe as kpp

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    out = {"tree": src, "resources": {
        name: res for name, res in build.info().resources.items()
        if "kpp" in name}}
    for shape, (m, n, L) in {**SHAPES, **DIAGNOSTIC}.items():
        x, cands, d = probe_inputs(m, n, L, seed=m + n)
        nbytes = 4 * (m * n + m + L * n + m * L + L)
        flops = 2 * m * L * n + 2 * m * n + 2 * L * n
        bound_us = 1e6 * max(nbytes / HBM_BYTES_PER_S,
                             flops / F32_FLOP_PER_S)
        launches = 3 if m > 1_000_000 else 50
        us = graph_us(lambda: kpp.kpp_probe_cuda(x, cands, d), launches)
        out[shape] = {
            "m": m, "n": n, "L": L, "us": us,
            "plain_us": graph_us(lambda: kpp.kpp_probe_plain(x, cands, d),
                                 launches),
            "read_x_us": graph_us(lambda: x.sum(), launches),
            "launches_us": launch_us(lambda: kpp.kpp_probe_cuda(x, cands, d),
                                     launches),
            "bound_us": bound_us, "bound_by": "bytes"
            if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S
            else "operations", "bytes": nbytes, "flops": flops,
            "share_of_bound": bound_us / us}
        out[shape].update(slot_times(x, d, L, 20 if m > 1_000_000 else 200))
        del x, cands, d
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="the other tree's root")
    parser.add_argument("--turn", metavar="SRC")
    args = parser.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_kpp: no CUDA device", file=sys.stderr)
        return 1
    trees = [("this", ROOT)]
    if args.against:
        other = ("other", Path(args.against).resolve())
        trees = [other, trees[0], trees[0], other]
    runs: dict = {}
    for name, root in trees:
        done = subprocess.run([sys.executable, __file__, "--turn",
                               str(root / "src")],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        line = done.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.setdefault(name, []).append(json.loads(line))
    summary = {}
    for name, rows in runs.items():
        for row in rows:
            for shape in {**SHAPES, **DIAGNOSTIC}:
                summary.setdefault(shape, {}).setdefault(name, []).append(
                    round(row[shape]["us"], 3))
    print(json.dumps({"profile_kpp": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
