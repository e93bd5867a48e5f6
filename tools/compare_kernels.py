#!/usr/bin/env python3
"""Hold the kernels of this checkout bitwise to another tree's.

    python3 tools/compare_kernels.py --against DIR

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Each tree
builds its own kernel library and runs kernels A, B, C, D (f32), A8, B8,
C8, D8 (int8), A16, B16, C16, D16 (bf16) and A3, B3, C3, D3 (bf16x3),
through ``repro_torch.kernels.ops`` where it dispatches them (untuned:
kernel A's ``pipeline="blocks"``), and the dma kernels A-dma, A8-dma,
A16-dma and A3-dma pinned (their wrappers called at every shape, inside
the fused envelope or not), on the same inputs (five shapes,
generated on the card from fixed seeds), in a process of its own; the
outputs are compared bit for bit, except B16's and B3's: kernels B16 and
B3 sum their f32 dots on the tensor cores, in an order of their own, so
against a tree whose kernel summed them otherwise their ids may differ at
near ties (rows whose best two scores at the policy lie within 1e-4
relative) and their d by a few ulps; for them the line gives the count of
differing ids, whether all of them are near ties, and the largest
|delta d| instead.  So for A16, D16, A3 and D3 where k and n lie outside
the fused envelope (there ``ops`` runs B16 and C16, B3 and C3): their sums
and counts must be bitwise, their objective is reported.  Kernel B (f32)
is held bitwise like every other output.  Prints one JSON line — how many
outputs were compared and which differ — and exits 1 if any other output
differs or a B16 or B3 id differs off a near tie.  Needs a CUDA card
(sm_90).  ``--dump SRC OUT`` is the per-tree step: run the
kernels of the package under ``SRC`` and save the outputs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(64_000, 25, 28), (64_001, 25, 3), (64_001, 130, 68),
          (3_001, 1024, 1024), (2_001, 1024, 1100)]   # (m, k, n)


def dump(src: str, out: str) -> None:
    """Run the f32, int8, bf16 and bf16x3 entry points of the package under
    ``src`` and save every output to ``out``."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels import distance, fused_step, ops, update
    from repro_torch.kernels import precision as px

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for m, k, n in SHAPES:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(m + k + n)
        c = torch.randn((k, n), generator=gen, device="cuda") * 5.0
        comp = torch.randint(0, k, (m,), generator=gen, device="cuda")
        x = (c[comp] + torch.randn((m, n), generator=gen, device="cuda")
             ).contiguous()
        qx = px.quantize_chunk(x)
        ids, d = distance.assign_f32(x, c)
        xb = torch.stack([x, x.flip(0), x * 0.5])
        cb = torch.stack([c, c + 0.1, c * 0.5])
        shape = f"{m},{k},{n}"
        for prec, tag in (("bf16", "16"), ("bf16x3", "3")):
            xs = px.cast_storage(x, prec)
            scores = px.sqnorm(c)[None, :] - 2.0 * px.dot(
                xs, c, ([1], [1]), prec)
            two = torch.topk(scores, 2, dim=1, largest=False).values
            results[f"B{tag} near ties {shape}"] = (
                (two[:, 1] - two[:, 0]) <= 1e-4 * two[:, 0].abs(),)
        results.update({
            f"fits {shape}": (torch.tensor(fused_step.fits(k, n)),),
            f"B {shape}": (ids, d),
            f"C {shape}": update.update_f32(x, ids, k),
            f"A {shape}": ops.fused_step(x, c, impl="cuda"),
            f"D {shape}": ops.fused_step_batched(xb, cb, impl="cuda"),
            f"B8 {shape}": distance.assign_int8(qx, c),
            f"C8 {shape}": update.update_int8(qx, ids, k),
            f"A8 {shape}": ops.fused_step(qx, c, impl="cuda"),
            f"D8 {shape}": ops.fused_step_batched(px.quantize_chunk(xb), cb,
                                                  impl="cuda"),
        })
        for prec, tag in (("bf16", "16"), ("bf16x3", "3")):
            results.update({
                f"B{tag} {shape}": distance.assign_16(x, c, prec),
                f"C{tag} {shape}": update.update_16(x, ids, k, prec),
                f"A{tag} {shape}": ops.fused_step(x, c, impl="cuda",
                                                  precision=prec),
                f"D{tag} {shape}": ops.fused_step_batched(
                    xb, cb, impl="cuda", precision=prec),
                f"A{tag}-dma {shape}": fused_step.fused_step_16(
                    x, c, prec, pipeline="dma"),
            })
        results.update({   # the dma kernels pinned, at every shape
            f"A-dma {shape}": fused_step.fused_step_f32(x, c, pipeline="dma"),
            f"A8-dma {shape}": fused_step.fused_step_int8(qx, c,
                                                          pipeline="dma"),
        })
    torch.cuda.synchronize()
    torch.save({key: tuple(t.cpu() for t in val)
                for key, val in results.items()}, out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="the other tree's root")
    parser.add_argument("--dump", nargs=2, metavar=("SRC", "OUT"))
    args = parser.parse_args()
    if args.dump:
        dump(*args.dump)
        return 0
    if not args.against:
        parser.error("--against DIR or --dump SRC OUT is needed")
    import torch

    outdir = ROOT / "build" / "compare_kernels"
    outdir.mkdir(parents=True, exist_ok=True)
    # untuned launches in both trees: no tuning, no cache file
    env = {key: val for key, val in os.environ.items()
           if not key.startswith("REPRO_AUTOTUNE")}
    saved = []
    for name, root in (("other", Path(args.against).resolve()),
                       ("this", ROOT)):
        out = outdir / f"{name}.pt"
        subprocess.run([sys.executable, __file__, "--dump",
                        str(root / "src"), str(out)], check=True, env=env)
        saved.append(torch.load(out))
    other, this = saved
    tensor_cores = {}                  # B16 and B3, and what routes via them
    for tag in ("16", "3"):
        for key in [key for key in this if key.startswith(f"B{tag} ")
                    and "near ties" not in key]:
            if key not in other:
                continue
            (ids_o, d_o), (ids_t, d_t) = other[key], this[key]
            ties = this[f"B{tag} near ties" + key[len(tag) + 1:]][0]
            apart = ids_o != ids_t
            tensor_cores[key] = {
                "ids_differ": int(apart.sum()),
                "all_near_ties": bool(ties[apart].all()),
                "max_abs_d_diff": float((d_o - d_t).abs().max()),
                "d_bitwise": bool(torch.equal(d_o, d_t))}
        for key in [key for key in this
                    if key.split(" ")[0] in (f"A{tag}", f"D{tag}")
                    and not bool(this["fits " + key.split(" ")[1]][0])]:
            if key not in other:
                continue
            (s_o, c_o, f_o), (s_t, c_t, f_t) = other[key], this[key]
            tensor_cores[key] = {
                "sums_counts_bitwise": bool(torch.equal(s_o, s_t)
                                            and torch.equal(c_o, c_t)),
                "max_rel_obj_diff": float(((f_o - f_t).abs()
                                           / f_o.abs()).max())}
    differ = sorted(key for key in other if key not in tensor_cores and (
        key not in this or not all(
            torch.equal(a, b) for a, b in zip(other[key], this[key]))))
    print(json.dumps({"compare_kernels": {
        "against": args.against, "outputs": len(other),
        "differ": differ, "tensor_cores": tensor_cores}}), flush=True)
    return 1 if differ or not all(
        row.get("all_near_ties", True) and row.get("sums_counts_bitwise", True)
        for row in tensor_cores.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
