"""Perf-iteration runner, the reference's ``repro.launch.perf``.

Runs one (arch x shape) cell of the dry run (``launch.dryrun``) on the
single-pod mesh with a named set of switches (``models.flags``) and
appends the roofline record, with the variant and its switches, to
``results/perf_torch.jsonl``:

    PYTHONPATH=src python -m repro_torch.launch.perf --arch hymba-1.5b \\
        --shape train_4k --variant blockwise --set blockwise_attn=1024

``cache_carry`` (the reference's ``DECODE_CACHE_CARRY``) has no
counterpart: the port's decode writes each layer's cache slice in place,
so setting it raises rather than run a variant that changes nothing.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_cell
from repro_torch.models import flags


def _bool(v) -> bool:
    return bool(int(v))


# setting -> (flag, parser)
_FLAGS = {
    "blockwise_attn": ("BLOCKWISE_ATTN", int),
    "bf16_grads": ("BF16_GRADS", _bool),
    "chunked_loss": ("CHUNKED_LOSS", int),
    "serve_moe_cap": ("SERVE_MOE_CAP", float),
    "attn_bf16_softmax": ("ATTN_BF16_SOFTMAX", _bool),
    "rope_bf16": ("ROPE_BF16", _bool),
    "seq_parallel": ("SEQ_PARALLEL", _bool),
    "remat": ("REMAT_POLICY", str),
    "cluster_bf16": ("CLUSTER_BF16", _bool),
    "kv_seq": ("KV_SHARD_SEQ", _bool),
    "ssd_bf16": ("SSD_BF16", _bool),
    "moe_groups": ("MOE_GROUPED_DISPATCH", int),
}


def apply_flags(settings: dict) -> None:
    """Set the switches named in ``settings`` (the reference's keys)."""
    if "cache_carry" in settings:
        raise ValueError(
            "cache_carry: the port has no DECODE_CACHE_CARRY switch (its "
            "decode writes each layer's cache slice in place), so the "
            "variant would change nothing")
    unknown = set(settings) - set(_FLAGS)
    if unknown:
        raise ValueError(f"unknown settings {sorted(unknown)}; known: "
                         f"{sorted(_FLAGS)}")
    for key, value in settings.items():
        name, parse = _FLAGS[key]
        setattr(flags, name, parse(value))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="base")
    ap.add_argument("--set", default="",
                    help="comma list k=v of " + ", ".join(sorted(_FLAGS)))
    ap.add_argument("--json", default="results/perf_torch.jsonl")
    args = ap.parse_args(argv)

    settings = {}
    for kv in filter(None, args.set.split(",")):
        k, v = kv.split("=")
        settings[k.strip()] = v.strip()
    apply_flags(settings)

    rec = run_cell(args.arch, args.shape, multi_pod=False)
    rec["variant"] = args.variant
    rec["flags"] = settings
    d = os.path.dirname(args.json)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.json, "a") as f:
        f.write(json.dumps(rec) + "\n")
    r = rec.get("roofline", {})
    print(f"[perf] {args.arch} x {args.shape} [{args.variant}] "
          f"compute={r.get('compute_s', 0):.4f}s "
          f"memory={r.get('memory_s', 0):.4f}s "
          f"collective={r.get('collective_s', 0):.4f}s "
          f"dominant={r.get('dominant')} "
          f"frac={r.get('roofline_fraction', 0):.4f}")


if __name__ == "__main__":
    main()
