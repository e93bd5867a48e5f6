#!/usr/bin/env python3
"""Device time of the fused kernels A, D and A-dma under every policy, and
of their CTA body's argmin phase alone.

    python3 tools/profile_fused.py [--against DIR]

Kernels A, A8, A16, A3 and their dma twins at the main path's shape
(m = 64,000, k = 25, n = 28) and at the fused envelope's edge (m = 64,000,
k = n = 1,024), and D, D8, D16, D3 at B = 8 streams of the main shape, on
points around well-separated centres generated on the card from fixed
seeds.  Beside each policy's A: ``tools/fused_phases.cu`` compiled against
the tree's ``kernels/csrc`` — the CTA body up to its accumulate phase
(per point tile, ``tile_argmin`` and the objective's ``block_sum``) on A's
grid, and where the tree has it, that phase plus the tile's sort into runs
(``common.cuh:find_runs``).  A's kernel time less the argmin phase's is
its accumulate phase.

For each kernel: device µs per call of the entry point by CUDA-graph
replay (its ``sqnorm_rows`` and reduce launches included), and each
launch's device µs per call from ``torch.profiler`` (CUDA activity); and
ptxas's registers, shared memory and spills of every fused kernel.

``--against DIR`` times another tree too (for example the parent commit
unpacked with ``git archive`` into ``build/parent``): each tree in a
process of its own, in turns other, this, this, other.  Prints one JSON
line per turn, then one line with each kernel's µs in both trees.  Needs a
CUDA card (sm_90).  ``--turn SRC`` is the per-tree step.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE = Path(__file__).resolve().parent / "fused_phases.cu"
MAIN, EDGE, BATCH = (64_000, 25, 28), (64_000, 1024, 1024), 8
POLICIES = ("f32", "int8", "bf16", "bf16x3")


def graph_us(fn, launches: int = 20, replays: int = 5) -> float:
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
    return 1e3 * start.elapsed_time(stop) / (launches * replays)


def launch_us(fn, calls: int) -> dict:
    """Device µs per call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def probe_library(src: Path, build_dir: Path):
    """``fused_phases.cu`` built against the tree under ``src`` (cached by
    the hash of its inputs), loaded; and whether it has the runs phase."""
    from repro_torch.kernels import build

    csrc = src / "repro_torch" / "kernels" / "csrc"
    runs = "find_runs(" in (csrc / "common.cuh").read_text()
    h = hashlib.sha256(PROBE.read_bytes())
    for name in build.HEADERS:
        h.update((csrc / name).read_bytes())
    h.update(str(runs).encode())
    lib = build_dir / f"fused_phases_{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".ptxas.txt")
    if not lib.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-shared", f"-I{csrc}",
               *(["-DPROBE_RUNS"] if runs else []), str(PROBE), "-o",
               str(lib)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
        log.write_text(done.stdout + done.stderr)
    probe = ctypes.CDLL(str(lib))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    probe.probe_launch.argtypes = [I, I, P, P, P, P, P, P, I64, I, I, I, P]
    probe.probe_launch.restype = I
    return probe, runs, build._parse_ptxas(log.read_text())


def mixture(shape, seed: int, batch: int = 0):
    """x [m,n] (or [batch,m,n]) around c [k,n] (or [batch,k,n]) on the
    card."""
    import torch

    m, k, n = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lead = (batch,) if batch else ()
    c = torch.randn(lead + (k, n), generator=gen, device="cuda") * 5.0
    comp = torch.randint(0, k, lead + (m,), generator=gen, device="cuda")
    noise = torch.randn(lead + (m, n), generator=gen, device="cuda")
    if batch:
        x = torch.stack([c[b][comp[b]] for b in range(batch)]) + noise
    else:
        x = c[comp] + noise
    return x.contiguous(), c


def turn(src: str) -> dict:
    """Time every fused kernel of the package under ``src`` and the argmin
    (and runs) phase of its CTA body."""
    src_path = Path(src).resolve()
    sys.path.insert(0, str(src_path))
    import torch

    from repro_torch.kernels import build, fused_step
    from repro_torch.kernels import precision as px

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    probe, has_runs, probe_res = probe_library(
        src_path, ROOT / "build" / "profile_fused")
    out = {"tree": src, "resources": {
        name: res for name, res in {**build.info().resources,
                                    **probe_res}.items()
        if "fused_step" in name or "probe" in name}}

    def probe_call(policy: str, runs: bool, x, c):
        """The argmin (runs) phase on ``x``'s chunk at kernel A's grid."""
        m, n = x.shape[-2:] if policy != "int8" else x.q.shape
        k = c.shape[0]
        grid = build.grid(x.q.device if policy == "int8" else x.device, m,
                          k * n + k + 1)
        objs = torch.empty(grid, dtype=torch.float32, device="cuda")
        csq = px.sqnorm(c).contiguous()
        if policy == "int8":
            _, scale, _, cq, t = build.int8_operands(x, c, 2)
            args = (x.q.data_ptr(), cq.data_ptr(), csq.data_ptr(),
                    t.data_ptr(), scale.data_ptr())
        else:
            args = (x.data_ptr(), c.data_ptr(), csq.data_ptr(), None, None)
        index = POLICIES.index(policy)
        code = (0, 3, 1, 2)[index]      # fused_phases.cu's policy numbers

        def call():
            err = probe.probe_launch(
                code, int(runs), *args, objs.data_ptr(), m, k, n, grid,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe {policy}: CUDA error {err}")
        return call

    def kernels(x, c, dma: bool):
        """Entry points of A (and A-dma) under each policy on (x, c)."""
        qx = px.quantize_chunk(x)
        q, scale, cf, cq, t = build.int8_operands(qx, c, 2)
        xb = x.bfloat16()
        calls = {}
        for pipe in ("blocks", "dma") if dma else ("blocks",):
            tag = "" if pipe == "blocks" else "-dma"
            calls.update({
                f"A{tag}": lambda p=pipe: fused_step.fused_step_f32(
                    x, c, pipeline=p),
                f"A8{tag}": lambda p=pipe: fused_step.launch_fused_step_int8(
                    q, scale, cq, t, cf, p),
                f"A16{tag}": lambda p=pipe: fused_step.fused_step_16(
                    xb, c, "bf16", pipeline=p),
                f"A3{tag}": lambda p=pipe: fused_step.fused_step_16(
                    x, c, "bf16x3", pipeline=p)})
        phases = {"f32": x, "int8": qx, "bf16": xb, "bf16x3": x}
        for policy, xs in phases.items():
            calls[f"argmin {policy}"] = probe_call(policy, False, xs, c)
            if has_runs and policy in ("f32", "int8"):
                calls[f"argmin+runs {policy}"] = probe_call(policy, True, xs,
                                                            c)
        return calls

    x, c = mixture(MAIN, seed=1)
    out["main"] = {name: {"us": graph_us(fn), "launches_us": launch_us(fn, 20)}
                   for name, fn in kernels(x, c, dma=True).items()}
    xb8, cb8 = mixture(MAIN, seed=2, batch=BATCH)
    qb8 = px.quantize_chunk(xb8)
    q, scale, cf, cq, t = build.int8_operands(qb8, cb8, 3)
    xbb = xb8.bfloat16()
    batched = {
        "D": lambda: fused_step.fused_step_batched_f32(xb8, cb8),
        "D8": lambda: fused_step.launch_fused_step_batched_int8(q, scale, cq,
                                                                t, cf),
        "D16": lambda: fused_step.fused_step_batched_16(xbb, cb8, "bf16"),
        "D3": lambda: fused_step.fused_step_batched_16(xb8, cb8, "bf16x3")}
    out["batched"] = {name: {"us": graph_us(fn),
                             "launches_us": launch_us(fn, 20)}
                      for name, fn in batched.items()}
    del xb8, cb8, qb8, q, xbb
    x, c = mixture(EDGE, seed=3)
    out["edge"] = {name: {"us": graph_us(fn, launches=1, replays=3),
                          "launches_us": launch_us(fn, 1)}
                   for name, fn in kernels(x, c, dma=True).items()}
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
        print("profile_fused: no CUDA device", file=sys.stderr)
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
            for shape in ("main", "batched", "edge"):
                for kernel, val in row[shape].items():
                    summary.setdefault(f"{kernel} {shape}", {}).setdefault(
                        name, []).append(round(val["us"], 2))
    print(json.dumps({"profile_fused": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
