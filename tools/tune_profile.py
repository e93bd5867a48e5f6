"""Tune the port's launch choices on the card and write them as a profile.

Times every candidate (``repro_torch.kernels.autotune``, by CUDA events)
at the shapes ``chip_smoke.py`` runs on its main paths, and writes the
winners to ``--out`` (``{"version": 1, "entries": {...}}``, keys naming
the card's backend, ``cuda-sm_90`` on an H100):

* the HEPMASS fits of phases 4-6 (m = 10.5M, n = 28, k = 25, s = 64,000,
  32 chunks), sequential and ``batch=8, sync_every=2``, under f32, int8,
  bf16 and bf16x3 (``fit(..., autotune=True)``: the fused step, the
  assignment and the batched step at the chunk's shape);
* the two-pass data set of phases 5c and 5f (m = 1,048,576, n = 1,024,
  k = 2,048, s = 16,384, 4 chunks) under each policy;
* the serving buckets of the default ``ServeConfig`` at phase 10's
  tenants (k = 25, n = 28 under each policy; k = 2,048, n = 1,024 in
  f32), through ``ops.warm_assign``.

Run on the card and bring the profile back:

    python3 tools/tune_profile.py --out build/cuda-sm_90.json

then commit it as ``results/autotune/cuda-sm_90.json``.  A fit reads it
with ``REPRO_AUTOTUNE_CACHE=results/autotune/cuda-sm_90.json`` (or
``autotune.set_cache_path``), tuning on or off; every candidate leaves
every output bitwise equal.  Prints one JSON line a step, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import BigMeansConfig, fit  # noqa: E402
from repro_torch.data.synthetic import GMMSpec, gmm_dataset  # noqa: E402
from repro_torch.kernels import autotune, build, ops  # noqa: E402
from repro_torch.serve.config import ServeConfig  # noqa: E402

POLICIES = ("f32", "int8", "bf16", "bf16x3")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def tune_fits(X, base: BigMeansConfig, batched: bool, label: str) -> None:
    for prec in POLICIES:
        runs = [("sequential", base.replace(precision=prec))]
        if batched:
            runs.append(("batched", base.replace(precision=prec, batch=8,
                                                 sync_every=2)))
        for name, cfg in runs:
            n0 = len(autotune.timings())
            t0 = time.monotonic()
            fit(X, cfg, autotune=True)
            torch.cuda.synchronize()
            emit({"step": label, "precision": prec, "run": name,
                  "seconds": time.monotonic() - t0,
                  "timed": [{"key": k, "candidate": c, "us": 1e6 * s}
                            for k, c, s in autotune.timings()[n0:]]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "cuda-sm_90.json"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    build.load()
    autotune.clear()
    autotune.set_cache_path(out)
    autotune.enable(True)
    smi = card()
    try:
        X = gmm_dataset(GMMSpec(m=10_500_000, n=28, components=25,
                                seed=args.seed), device="cuda")
        tune_fits(X, BigMeansConfig(k=25, s=64_000, n_chunks=32,
                                    seed=args.seed), True, "hepmass")
        del X
        X2 = gmm_dataset(GMMSpec(m=1 << 20, n=1024, components=2048,
                                 seed=args.seed), device="cuda")
        tune_fits(X2, BigMeansConfig(k=2048, s=16_384, n_chunks=4,
                                     seed=args.seed), False, "two_pass")
        del X2
        torch.cuda.empty_cache()
        buckets = ServeConfig().buckets()
        for prec, (k, n) in [(p, (25, 28)) for p in POLICIES] + [
                ("f32", (2048, 1024))]:
            n0 = len(autotune.timings())
            for b in buckets:
                ops.warm_assign(b, k, n, precision=prec)
            emit({"step": "serving", "precision": prec, "k": k, "n": n,
                  "buckets": list(buckets),
                  "timed": [{"key": key, "candidate": c, "us": 1e6 * s}
                            for key, c, s in autotune.timings()[n0:]]})
    finally:
        autotune.enable(False)
    entries = json.loads(out.read_text())["entries"]
    emit({"step": "profile", "path": str(out), "entries": len(entries),
          "winners": entries, "card": smi})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
