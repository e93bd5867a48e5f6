"""Render a dry run's records into the roofline tables, the reference's
``repro.launch.report`` (its functions unchanged, so both packages render
the same records alike).

    PYTHONPATH=src python -m repro_torch.launch.report \
        results/dryrun_torch.jsonl

The port's records are counts on a fake mesh (``launch.dryrun``): its
"compile s" column is the dispatch's seconds, its per-device figures are
rank 0's, and its hints name the reference's remedies.
"""
from __future__ import annotations

import json
import sys
from collections import OrderedDict


def load(path):
    recs = OrderedDict()
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r   # last write wins
    return list(recs.values())


def fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def dryrun_table(recs):
    rows = ["| arch | shape | mesh | status | compile s | args/dev | temps/dev | collectives (count) |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP — "
                        f"{r['reason'][:60]}… | | | | |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR | | | | |")
            continue
        mem = r.get("memory_analysis", {})
        nd = r["devices"]
        coll = r.get("collective_raw", r.get("collective", {}))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['compile_s']:.1f} | "
            f"{fmt_bytes(mem.get('argument_bytes', 0) / nd)} | "
            f"{fmt_bytes(mem.get('temp_bytes', 0))} | "
            f"{coll.get('count', 0)} |")
    return "\n".join(rows)


def roofline_table(recs):
    rows = ["| arch | shape | compute s | memory s | collective s | dominant | "
            "roofline frac | 6ND/HLO | what would move the dominant term |",
            "|---|---|---|---|---|---|---|---|---|"]
    hints = {
        ("compute",): "higher arithmetic intensity (larger per-chip tiles), "
                      "drop remat recompute on cheap ops",
        ("memory",): "blockwise attention (no S^2 logits in HBM), bf16/int8 "
                     "weight streaming, fused softmax",
        ("collective",): "reduce-scatter instead of all-reduce, bf16 grads, "
                         "overlap collectives with per-layer compute",
    }
    for r in recs:
        if r["mesh"] != "16x16":
            continue
        if r["status"] == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP | — "
                        f"| — | {r['reason'][:70]} |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | ERROR | "
                        f"— | — | |")
            continue
        rl = r["roofline"]
        ratio = r.get("useful_flops_ratio", float("nan"))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4f} | "
            f"{rl['memory_s']:.4f} | {rl['collective_s']:.4f} | "
            f"{rl['dominant']} | {rl['roofline_fraction']:.3f} | "
            f"{ratio:.3f} | {hints[(rl['dominant'],)]} |")
    return "\n".join(rows)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch.jsonl"
    recs = load(path)
    print("## Dry-run matrix\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16, per device)\n")
    print(roofline_table(recs))
    ok = sum(r["status"] == "ok" for r in recs)
    skip = sum(r["status"] == "skip" for r in recs)
    err = sum(r["status"] == "error" for r in recs)
    print(f"\ncells: {ok} ok / {skip} skip / {err} error")


if __name__ == "__main__":
    main()
