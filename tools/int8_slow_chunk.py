#!/usr/bin/env python3
"""Capture the chunk on which int8 batched Lloyd runs longest, on one card.

    python3 tools/int8_slow_chunk.py [--seed N] [--out DIR]
    python3 tools/int8_slow_chunk.py --replay tests/data/int8_slow_chunk.npz

Builds the HEPMASS-shaped mixture of ``chip_smoke.py`` phase 4 (same
generator, same seed) and replays its Big-means fits through the core
drivers: batched (``batch=8, sync_every=2``) and sequential, each in f32
and in int8, 32 chunks of s = 64,000 with k = 25.  Every call of
``kmeans.lloyd_batched`` is recorded.  For the stream that took the most
int8 iterations it then runs, on that chunk and its initial centroids:
the port's ``lloyd`` and ``lloyd_batched`` (B = 1) at int8 through the
kernels and through the plain path, ``lloyd`` at f32, and the int8
objective of every iteration.

Prints one JSON object per line and writes the chunk's int8 codes, scales
and initial centroids to ``DIR/int8_slow_chunk.npz``
(default ``build``): ``tests/data/int8_slow_chunk.npz`` is one such
capture, which ``tests/test_torch_int8.py`` runs through the reference on
the CPU.  ``--replay`` runs only the port's Lloyd on a captured chunk, on
the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import big_means, big_means_batched, kmeans  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    PAPER_DATASETS, GMMSpec, gmm_dataset,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import precision as px  # noqa: E402

K, S, N_CHUNKS, BATCH, SYNC_EVERY = 25, 64_000, 32, 8, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def batched_calls(X, seed: int, precision: str):
    """Replay the batched fit; returns [(points, init, iterations)] per
    ``lloyd_batched`` call, one per round."""
    calls = []
    inner = kmeans.lloyd_batched

    def record(points, init, **kw):
        res = inner(points, init, **kw)
        calls.append((points.clone(), init.float().clone(),
                      res.iterations.cpu().tolist()))
        return res

    kmeans.lloyd_batched = record
    try:
        big_means_batched(X, rnd.TORCH.key(seed), k=K, s=S, batch=BATCH,
                          rounds=N_CHUNKS // BATCH, sync_every=SYNC_EVERY,
                          precision=precision)
    finally:
        kmeans.lloyd_batched = inner
    return calls


def objective_trace(qx, init, iterations: int, impl: str) -> list[float]:
    """The loop's int8 objective at each of ``iterations`` Lloyd steps."""
    c, fs = init, []
    for _ in range(iterations):
        sums, counts, f = ops.fused_step(qx, c, impl=impl, precision="int8")
        c = torch.where(counts[:, None] > 0, sums / counts[:, None], c)
        fs.append(float(f))
    return fs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=str(ROOT / "build"))
    parser.add_argument("--replay", metavar="NPZ",
                        help="only run Lloyd on a chunk captured before")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("int8_slow_chunk: no CUDA device", file=sys.stderr)
        return 1
    if args.replay:
        return replay(args.replay)
    torch.backends.cuda.matmul.allow_tf32 = False

    m, n = PAPER_DATASETS["hepmass"]
    X = gmm_dataset(GMMSpec(m=m, n=n, components=K, seed=args.seed),
                    device="cuda")
    per_chunk = {}
    for precision in ("f32", "int8"):
        _, infos = big_means(X, rnd.TORCH.key(args.seed), k=K, s=S,
                             n_chunks=N_CHUNKS, precision=precision)
        per_chunk[f"sequential_{precision}"] = infos.lloyd_iters.tolist()
    calls = {p: batched_calls(X, args.seed, p) for p in ("f32", "int8")}
    for p, cs in calls.items():
        per_chunk[f"batched_{p}"] = [it for _, _, its in cs for it in its]
    emit({"phase": "iterations_per_chunk", **per_chunk})

    # the slowest int8 stream: its chunk, its initial centroids
    its = per_chunk["batched_int8"]
    slow = max(range(len(its)), key=its.__getitem__)
    rnd_, b = divmod(slow, BATCH)
    points_b, init_b, _ = calls["int8"][rnd_]
    P, C0 = points_b[b].contiguous(), init_b[b].contiguous()
    qx = px.quantize_chunk(P)
    q_batch = px.quantize_chunk(points_b)
    assert torch.equal(qx.q, q_batch.q[b]) and torch.equal(
        qx.scale, q_batch.scale[b]), "per-stream quantization differs"
    same_chunk_f32 = torch.equal(calls["f32"][rnd_][0][b], P)
    same_init_f32 = torch.equal(calls["f32"][rnd_][1][b], C0)

    run = {}
    for impl in ("cuda", "ref"):
        r1 = kmeans.lloyd(P, C0, impl=impl, precision="int8")
        rb = kmeans.lloyd_batched(P[None], C0[None], impl=impl,
                                  precision="int8")
        run[impl] = {"lloyd": r1.iterations,
                     "lloyd_batched": int(rb.iterations[0]),
                     "objective": float(r1.objective)}
    r32 = kmeans.lloyd(P, C0, impl="cuda", precision="f32")
    trace = objective_trace(qx, C0, run["cuda"]["lloyd"], "cuda")
    emit({"phase": "slow_chunk", "round": rnd_, "stream": b,
          "iterations_in_fit": its[slow],
          "f32_same_chunk_in_fit": same_chunk_f32,
          "f32_same_init_in_fit": same_init_f32,
          "f32_iterations_in_fit": per_chunk["batched_f32"][slow],
          "int8": run, "f32_from_same_init": {
              "lloyd": r32.iterations, "objective": float(r32.objective)},
          "int8_objective_per_iteration": trace,
          "relative_steps": [abs(a - b_) / abs(a)
                             for a, b_ in zip(trace, trace[1:])]})

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    q, scale = convert.quantized_to_numpy(qx)
    np.savez_compressed(out / "int8_slow_chunk.npz", q=q, scale=scale,
                        init=C0.cpu().numpy())
    emit({"wrote": str(out / "int8_slow_chunk.npz")})
    return 0


def replay(path: str) -> int:
    """Lloyd at int8 on a captured chunk (its codes and scales as they
    are), through the kernels and through the plain path on the card."""
    z = np.load(path)
    qx = convert.quantized_from_numpy(z["q"], z["scale"], device="cuda")
    C0 = torch.from_numpy(z["init"]).cuda()
    run = {}
    for impl in ("cuda", "ref"):
        r1 = kmeans.lloyd(qx, C0, impl=impl, precision="int8")
        rb = kmeans.lloyd_batched(
            px.QuantizedChunk(qx.q[None], qx.scale[None]), C0[None],
            impl=impl, precision="int8")
        run[impl] = {"lloyd": r1.iterations,
                     "lloyd_batched": int(rb.iterations[0]),
                     "objective": float(r1.objective)}
    emit({"phase": "replay", "chunk": path, "int8": run})
    return 0


if __name__ == "__main__":
    sys.exit(main())
