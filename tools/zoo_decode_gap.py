#!/usr/bin/env python3
"""How far the zoo's decoded logits sit from its forward's, by depth.

    python3 tools/zoo_decode_gap.py [--seeds 1 2 3] [--arch ARCH ...]

Each arch at its published width, random weights from each seed, random
tokens: the forward over the whole sequence, then a prefill of all but the
last 8 tokens and 8 decoded ones (``repro_torch.models.decode_check.
decode_gap``).  For hymba-1.5b at 4 layers of 1,100 tokens and at 8, 16
and 32 layers of 2,048 (B = 1, and B = 8 at 32 layers); for
seamless-m4t-medium at full depth and deepseek-moe-16b /
qwen3-moe-235b-a22b at 4 / 2 layers, B = 2 x 256 with
``capacity_factor = E / top_k``.  Each at ``COMPUTE_DTYPE`` bf16 and
float32 (the SSD's hard-coded bf16 casts and the bf16 KV cache stay).
Prints one JSON line a case and seed: the largest |decoded - forward|
logit, the forward's logit scale, the held rows' gap and the router margin
of each rerouted step, the cache gap; then the card's name and power
limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.models import decode_check as dc  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CASES = [  # (arch, layers, B, S)
    ("hymba-1.5b", 4, 1, 1100), ("hymba-1.5b", 8, 1, 2048),
    ("hymba-1.5b", 16, 1, 2048), ("hymba-1.5b", 32, 1, 2048),
    ("hymba-1.5b", 32, 8, 2048), ("seamless-m4t-medium", 12, 2, 256),
    ("deepseek-moe-16b", 4, 2, 256), ("qwen3-moe-235b-a22b", 2, 2, 256),
]


def gap(arch: str, n_layers: int, B: int, S: int, dtype, seed: int) -> dict:
    layers.COMPUTE_DTYPE = dtype
    try:
        cfg = dataclasses.replace(registry.get_config(arch),
                                  num_layers=n_layers)
        if cfg.moe:
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = T.init_params(cfg, gen, device=dev)
        tokens, frames = dc.random_inputs(cfg, B, S, gen, dev)
        dec = dc.decode_gap(cfg, model, tokens, frames, 8)
    finally:
        layers.COMPUTE_DTYPE = torch.bfloat16
    del model
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": n_layers, "batch": B, "seq": S,
            "seed": seed, "compute": str(dtype).removeprefix("torch."),
            "max_abs_err": dec["max_abs_err"], "rel": dec["rel"],
            "scale": max(s["scale"] for s in dec["steps"]),
            "held_max_abs_err": [s["held_max_abs_err"]
                                 for s in dec["steps"]],
            "steps_rerouted": dec["steps_rerouted"],
            "tie_margins": [s["tie_margin"] for s in dec["steps"]
                            if s["rows_rerouted"]],
            "cache_rows": dec["cache_rows"], "cache_rel": dec["cache_rel"],
            "faults": dc.decode_faults(dec, hybrid=cfg.family == "hybrid")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--arch", nargs="+", default=None,
                    help="only these archs' cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_decode_gap: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for case in CASES:
        if args.arch and case[0] not in args.arch:
            continue
        for seed in args.seeds:
            for dtype in (torch.bfloat16, torch.float32):
                print(json.dumps(gap(*case, dtype, seed)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
