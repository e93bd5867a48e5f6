#!/usr/bin/env python3
"""Whether the zoo's decode check sees a wrong decode: plant one fault at a
time in the decode path and read ``decode_check``'s numbers.

    python3 tools/zoo_decode_faults.py [--seed 0] [--out FILE]

Each fault of ``decode_check.FAULTS`` replaces one function of
``repro_torch.models`` for the length of one ``decode_gap`` call
(``decode_check.planted``; no file is changed): the SSD state zeroed or
never advanced, the K / V written one slot early, the windowed layers
decoding with no window or one a token wider.

hymba-1.5b at its published width and depth, B = 8 x 2,048 (prefill 2,040,
8 decoded) as ``chip_smoke.py`` 14a; seamless-m4t-medium, deepseek-moe-16b
at 4 layers and qwen3-moe-235b-a22b at 2, B = 2 x 256 with
``capacity_factor = E / top_k``, as 14b.  Prints one JSON line a case and
fault (the step and cache gaps, and what ``decode_faults`` reports), then
the card's name and power limit.  Needs a CUDA card.
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
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CASES = [  # (arch, layers, B, S, faults)
    ("hymba-1.5b", 32, 8, 2048, [None, *dc.FAULTS]),
    ("seamless-m4t-medium", 12, 2, 256, [None, "kv_write_pos_minus_1"]),
    ("deepseek-moe-16b", 4, 2, 256, [None, "kv_write_pos_minus_1"]),
    ("qwen3-moe-235b-a22b", 2, 2, 256, [None, "kv_write_pos_minus_1"]),
]


def run_case(arch: str, n_layers: int, B: int, S: int, faults, seed: int):
    cfg = dataclasses.replace(registry.get_config(arch), num_layers=n_layers)
    if cfg.moe:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.num_experts / cfg.top_k)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = T.init_params(cfg, gen, device=dev)
    tokens, frames = dc.random_inputs(cfg, B, S, gen, dev)
    for fault in faults:
        with dc.planted(fault):
            dec = dc.decode_gap(cfg, model, tokens, frames, 8)
        yield {"arch": arch, "layers": n_layers, "batch": B, "seq": S,
               "seed": seed, "fault": fault, "rel": dec["rel"],
               "max_abs_err": dec["max_abs_err"], "top1": dec["top1"],
               "held_max_abs_err": [s["held_max_abs_err"]
                                    for s in dec["steps"]],
               "scale": max(s["scale"] for s in dec["steps"]),
               "steps_rerouted": dec["steps_rerouted"],
               "tie_margins": [s["tie_margin"] for s in dec["steps"]],
               "cache_rows": dec["cache_rows"], "cache_rel": dec["cache_rel"],
               "faults": dc.decode_faults(dec, hybrid=cfg.family == "hybrid")}
    del model
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_decode_faults: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    lines = []
    for case in CASES:
        for row in run_case(*case, seed=args.seed):
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    lines.append(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
