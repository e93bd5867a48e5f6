"""Probe the zoo's train step on the card: determinism, remat, memory.

For hymba-1.5b at its published width (``--layers`` of its 32, default
all) and a batch of ``--batch`` x ``--seq`` random tokens from ``--seed``:

* ``value_and_grad`` twice as it runs by default and twice under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``: whether the
  four give the same loss and gradients bitwise, and each one's ms;
* the same under ``REMAT_POLICY="dots"``: bitwise "full", its ms and peak;
* one AdamW step: its ms and peak;
* deepseek-moe-16b at one full-width layer: ``value_and_grad`` twice,
  bitwise (the MoE dispatch's gathers have scatter-add backwards).

Prints one JSON line a measurement, with the card's name and power limit.
Run on the card: ``python3 tools/train_probe.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models import flags, registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer, train_step  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn):
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(
        torch.equal(a[1][k], b[1][k]) for k in a[1])


def batch_of(cfg, B, S, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    smi = card()
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "card": smi,
          "selective_checkpoint": hasattr(
              torch.utils.checkpoint, "create_selective_checkpoint_contexts")})

    cfg = dataclasses.replace(registry.get_config("hymba-1.5b"),
                              num_layers=args.layers)
    model = T.init_params(cfg, args.seed, device=dev)
    batch = batch_of(cfg, args.batch, args.seq, args.seed, dev)
    runs = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        for i in range(2):
            torch.cuda.reset_peak_memory_stats()
            out, ms = timed(lambda: train_step.value_and_grad(cfg, model,
                                                              batch))
            runs[(mode, i)] = out
            emit({"what": "value_and_grad", "policy": "full", "mode": mode,
                  "run": i, "ms": ms, "loss": float(out[0]),
                  "finite": all(bool(torch.isfinite(g).all())
                                for g in out[1].values()),
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "card": smi})
        torch.use_deterministic_algorithms(False)
        first = runs[(mode, 0)]
        emit({"what": "bitwise", "mode": mode,
              "two_runs": same(first, runs[(mode, 1)]),
              "against_default": same(first, runs[("default", 0)])})
        for key in [k for k in runs if k != ("default", 0)]:
            del runs[key]
        torch.cuda.empty_cache()

    flags.REMAT_POLICY = "dots"
    torch.cuda.reset_peak_memory_stats()
    out, ms = timed(lambda: train_step.value_and_grad(cfg, model, batch))
    emit({"what": "value_and_grad", "policy": "dots", "ms": ms,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "bitwise_full": same(out, runs[("default", 0)]), "card": smi})
    flags.REMAT_POLICY = "full"
    del out, runs
    torch.cuda.empty_cache()

    opt = optimizer.adamw(1e-3)
    state = opt.init(model)
    step = train_step.make_train_step(cfg, opt)
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        (model, state, m), ms = timed(lambda: step(model, state, batch))
        emit({"what": "train_step", "run": i, "ms": ms,
              "loss": float(m["loss"]),
              "tokens_per_s": args.batch * args.seq / (ms / 1e3),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card": smi})
    del model, state
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(registry.get_config("deepseek-moe-16b"),
                              num_layers=1)
    model = T.init_params(cfg, args.seed, device=dev)
    batch = batch_of(cfg, args.batch, args.seq, args.seed, dev)
    t0 = time.monotonic()
    a, ms_a = timed(lambda: train_step.value_and_grad(cfg, model, batch))
    b, ms_b = timed(lambda: train_step.value_and_grad(cfg, model, batch))
    emit({"what": "moe_bitwise", "arch": cfg.name, "layers": 1,
          "two_runs": same(a, b), "ms": [ms_a, ms_b],
          "wall_s": time.monotonic() - t0, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
