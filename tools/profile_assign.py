#!/usr/bin/env python3
"""Device time of each launch of the assign kernels B, B3, B8 and B16, and
the tensor-core kernels' bias.

    python3 tools/profile_assign.py

Kernel B (f32, ``csrc/assign.cu``) is two launches, three with more than
one centroid tile (the centroid norms ``sqnorm_chain_rows``, the
register-tiled CUDA-core pass ``assign_f32_pass``, the fold
``assign_fold_f32``); B8 three (the norms ``sqnorm_rows``, the tensor-core
pass ``assign_mma_kernel``, the fold ``assign_fold_kernel``), B16 four (and
the bf16 cast of the centroids), B3 six (the norms, the bf16 hi / lo split
``split_bf16_rows`` of c and of x, the pass on the hi and lo parts, the
fold ``assign_fold_f32``), ``src/repro_torch/kernels/csrc/assign_mma.cuh``.
At the main path's shape (m = 64,000, k = 25, n = 28), the two-pass
route's (s = 16,384, k = 2,048, n = 1,024) and k = 1,024, n = 1,100 (rows
off 16 bytes), on points around well-separated centres generated on the
card from fixed seeds (``chip_smoke.py``'s), this prints one JSON line per
shape: each kernel's device µs per call by CUDA-graph replay, each of its
launches' device µs per call from ``torch.profiler`` (CUDA activity), and
B16's and B3's objective (the sum of d) against their plain versions',
relative: the tensor cores' f32 accumulation does not round to nearest,
and the fold of each slab's partials on the CUDA cores keeps its bias
small.  Needs a CUDA card (sm_90).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_update import graph_us  # noqa: E402
from repro_torch.kernels import build, distance  # noqa: E402
from repro_torch.kernels import precision as px  # noqa: E402

SHAPES = [(64_000, 25, 28), (16_384, 2048, 1024), (20_001, 1024, 1100)]


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
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_assign: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    for m, k, n in SHAPES:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
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
        bias = {}
        for name, xs, prec in (("B16", xb, "bf16"), ("B3", x, "bf16x3")):
            _, d = distance.assign_16(xs, c, prec)
            _, pd = distance.assign_plain(xs, c, prec)
            bias[name] = float((d.double().sum() - pd.double().sum())
                               / pd.double().sum())
        print(json.dumps({"m": m, "k": k, "n": n, "kernels": {
            name: {"us": graph_us(fn), "launches_us": launch_us(fn)}
            for name, fn in calls.items()},
            "objective_rel_to_plain": bias}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
