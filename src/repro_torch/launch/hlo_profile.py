"""Per-op byte attribution of one dry-run step, the "profiler" of the dry
run, the reference's ``repro.launch.hlo_profile``.

The reference groups operand + result bytes of the optimized HLO by
opcode; here the rows are the aten ops rank 0 dispatches
(``hlo_analysis.Recorder``), so ``profile`` groups their operand + result
bytes by op and lists the top single ops, in the reference's
``(summary, top_rows)`` shape: ``summary`` is ``[(op, [bytes, count])]``
by bytes, ``top_rows`` ``[(op, name, bytes, detail)]`` with ``name`` the
op's index in dispatch order and ``detail`` its FLOPs.

    PYTHONPATH=src python -m repro_torch.launch.hlo_profile \\
        --arch hymba-1.5b --shape train_4k --layers 2 --set remat=dots
"""
from __future__ import annotations

from collections import defaultdict


def profile(rows, top: int = 25):
    by_op = defaultdict(lambda: [0, 0])
    table = []
    for i, r in enumerate(rows):
        b = r.in_bytes + r.out_bytes
        by_op[r.op][0] += b
        by_op[r.op][1] += 1
        table.append((r.op, f"%{i}", b, f"flops={r.flops}"))
    summary = sorted(by_op.items(), key=lambda kv: -kv[1][0])
    top_rows = sorted(table, key=lambda r: -r[2])[:top]
    return summary, top_rows


def main(argv=None) -> None:
    import argparse
    import dataclasses

    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.perf import apply_flags
    from repro_torch.models.registry import get_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--set", default="")
    args = ap.parse_args(argv)

    apply_flags(dict(kv.split("=")
                     for kv in filter(None, args.set.split(","))))
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, num_layers=args.layers,
        encoder_layers=args.layers if cfg.encoder_layers else 0)
    cost = dryrun.count_step(cfg, SHAPES[args.shape])
    summary, top_rows = profile(cost["rows"])
    total = sum(v[0] for _, v in summary)
    print(f"total attributed bytes/device: {total:.3e} "
          f"(bytes_per_device: {cost['bytes']:.3e})")
    print("\n-- by op --")
    for op, (b, c) in summary[:18]:
        print(f"{op:24s} {b:.3e}  x{c}")
    print("\n-- top ops --")
    for op, name, b, meta in top_rows:
        print(f"{b: .3e}  {op:18s} {name:28s} {meta[:90]}")


if __name__ == "__main__":
    main()
