#!/usr/bin/env python3
"""Capture the chunk on which int8 (or bf16) batched Lloyd runs longest.

    python3 tools/int8_slow_chunk.py [--precision int8|bf16] [--seed N]
                                     [--out DIR]
    python3 tools/int8_slow_chunk.py --replay tests/data/int8_slow_chunk.npz

Builds the HEPMASS-shaped mixture of ``chip_smoke.py`` phase 4 (same
generator, same seed) and replays its Big-means fits through the core
drivers: batched (``batch=8, sync_every=2``) and sequential, each in f32
and at the precision asked for, 32 chunks of s = 64,000 with k = 25.
Every call of ``kmeans.lloyd_batched`` is recorded.  For the stream that
took the most iterations at that precision it then runs, on that chunk and
its initial centroids: the port's ``lloyd`` and ``lloyd_batched`` (B = 1)
at the precision through the kernels and through the plain path, ``lloyd``
at f32, and the loop objective of every iteration.

Prints one JSON object per line and writes the chunk in its storage (int8
codes and scales, or the bf16 values as their 16 bits) and the initial
centroids to ``DIR/<precision>_slow_chunk.npz`` (default ``build``):
``tests/data/int8_slow_chunk.npz`` and ``tests/data/bf16_slow_chunk.npz``
are such captures, which ``tests/test_torch_int8.py`` and
``tests/test_torch_bf16.py`` run through the reference on the CPU.
``--replay`` runs only the port's Lloyd on a captured chunk, on the card.
Needs one CUDA card.
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


def objective_trace(xs, init, iterations: int, impl: str,
                    precision: str) -> list[float]:
    """The loop's objective at each of ``iterations`` Lloyd steps on the
    chunk in its storage ``xs``."""
    c, fs = init, []
    for _ in range(iterations):
        sums, counts, f = ops.fused_step(xs, c, impl=impl,
                                         precision=precision)
        c = torch.where(counts[:, None] > 0, sums / counts[:, None], c)
        fs.append(float(f))
    return fs


def save_chunk(path: Path, xs, init) -> None:
    """The chunk in its storage and the initial centroids, as a compressed
    npz: int8 codes and scales, or the bf16 values' 16 bits as two byte
    planes (``hi``, ``lo``: the high bytes compress well)."""
    if isinstance(xs, px.QuantizedChunk):
        q, scale = convert.quantized_to_numpy(xs)
        arrays = dict(q=q, scale=scale)
    else:
        bits = xs.view(torch.int16).cpu().numpy().view(np.uint16)
        arrays = dict(hi=(bits >> 8).astype(np.uint8),
                      lo=(bits & 0xFF).astype(np.uint8))
    np.savez_compressed(path, init=init.cpu().numpy(), **arrays)


def bf16_bits(z) -> np.ndarray:
    """The bf16 values' 16 bits of a capture, from its byte planes."""
    return (z["hi"].astype(np.uint16) << 8) | z["lo"]


def load_chunk(path: str):
    """(chunk in its storage on the card, init, precision) of a capture."""
    z = np.load(path)
    init = torch.from_numpy(z["init"]).cuda()
    if "q" in z:
        return (convert.quantized_from_numpy(z["q"], z["scale"],
                                             device="cuda"), init, "int8")
    bits = torch.from_numpy(bf16_bits(z).view(np.int16)).cuda()
    return bits.view(torch.bfloat16), init, "bf16"


def lloyd_runs(xs, init, precision: str) -> dict:
    """Iterations and objective of ``lloyd`` and ``lloyd_batched`` (B = 1)
    on a chunk in its storage, through the kernels and the plain path."""
    batched = (px.QuantizedChunk(xs.q[None], xs.scale[None])
               if isinstance(xs, px.QuantizedChunk) else xs[None])
    run = {}
    for impl in ("cuda", "ref"):
        r1 = kmeans.lloyd(xs, init, impl=impl, precision=precision)
        rb = kmeans.lloyd_batched(batched, init[None], impl=impl,
                                  precision=precision)
        run[impl] = {"lloyd": r1.iterations,
                     "lloyd_batched": int(rb.iterations[0]),
                     "objective": float(r1.objective)}
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--precision", choices=("int8", "bf16"),
                        default="int8")
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
    prec = args.precision

    m, n = PAPER_DATASETS["hepmass"]
    X = gmm_dataset(GMMSpec(m=m, n=n, components=K, seed=args.seed),
                    device="cuda")
    per_chunk = {}
    for precision in ("f32", prec):
        _, infos = big_means(X, rnd.TORCH.key(args.seed), k=K, s=S,
                             n_chunks=N_CHUNKS, precision=precision)
        per_chunk[f"sequential_{precision}"] = infos.lloyd_iters.tolist()
    calls = {p: batched_calls(X, args.seed, p) for p in ("f32", prec)}
    for p, cs in calls.items():
        per_chunk[f"batched_{p}"] = [it for _, _, its in cs for it in its]
    emit({"phase": "iterations_per_chunk", **per_chunk})

    # the slowest stream at the precision: its chunk, its initial centroids
    its = per_chunk[f"batched_{prec}"]
    slow = max(range(len(its)), key=its.__getitem__)
    rnd_, b = divmod(slow, BATCH)
    points_b, init_b, _ = calls[prec][rnd_]
    P, C0 = points_b[b].contiguous(), init_b[b].contiguous()
    xs = px.cast_storage(P, prec)
    if prec == "int8":
        q_batch = px.quantize_chunk(points_b)
        assert torch.equal(xs.q, q_batch.q[b]) and torch.equal(
            xs.scale, q_batch.scale[b]), "per-stream quantization differs"
    same_chunk_f32 = torch.equal(calls["f32"][rnd_][0][b], P)
    same_init_f32 = torch.equal(calls["f32"][rnd_][1][b], C0)

    run = lloyd_runs(xs, C0, prec)
    r32 = kmeans.lloyd(P.float(), C0, impl="cuda", precision="f32")
    trace = objective_trace(xs, C0, run["cuda"]["lloyd"], "cuda", prec)
    emit({"phase": "slow_chunk", "precision": prec, "round": rnd_,
          "stream": b, "iterations_in_fit": its[slow],
          "f32_same_chunk_in_fit": same_chunk_f32,
          "f32_same_init_in_fit": same_init_f32,
          "f32_iterations_in_fit": per_chunk["batched_f32"][slow],
          prec: run, "f32_from_same_init": {
              "lloyd": r32.iterations, "objective": float(r32.objective)},
          "objective_per_iteration": trace,
          "relative_steps": [abs(a - b_) / abs(a)
                             for a, b_ in zip(trace, trace[1:])]})

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{prec}_slow_chunk.npz"
    save_chunk(path, xs, C0)
    emit({"wrote": str(path)})
    return 0


def replay(path: str) -> int:
    """Lloyd at the capture's precision on a captured chunk (in its
    storage, as it is), through the kernels and through the plain path on
    the card."""
    xs, C0, prec = load_chunk(path)
    emit({"phase": "replay", "chunk": path, prec: lloyd_runs(xs, C0, prec)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
