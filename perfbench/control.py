"""The readings that the limits of ``correct`` are set from.

For one cell, in one process: the program as the benchmark runs it, on
each of ``--seeds`` (a run's judgement: ``check_jobs`` jobs, the largest
reading of each number), and on each of ``--control-seeds``

* ``plain_tf32`` — the control: the plain reference
  (:mod:`perfbench.reference.plain`) in the program's place, computed in
  TF32, the precision just below the configuration's float32;
* ``plain_f32`` — the same reference in float32, which must pass;
* ``program_bf16x3`` — the program's own three-bf16-product route
  (``fit(precision="bf16x3")``, the assignment at ``bf16x3``), which
  decides the compute peak of the roofline shares;
* the faults, planted in the program: ``fault_unchanged`` (a Lloyd step
  that returns its centroids unchanged), ``fault_half`` (the step's means
  taken over half of the chunk), ``fault_id`` (one row's id altered in
  every assignment the program makes), ``fault_accept`` (every chunk's
  solution kept, whatever its objective);
* ``denominator_f32`` — the benchmark's own objective of the true means
  taken in float32, the step below its float64.

    python3 perfbench/control.py --workload codebook.fit \
        --seeds 11,12 --control-seeds 21,22,23 --out chiprun_out/x.jsonl

Each reading is printed (and appended to ``--out``) as a JSON line.  Runs
on the card; ``--device cpu`` with ``--shrink`` runs it at a size a test
holds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def variant(loop_cls, name: str):
    """``loop_cls`` with the fit and the assignment of ``name``."""
    import torch

    from perfbench.reference import plain

    if name == "program":
        return loop_cls
    if name in FAULTS:
        class Fault(loop_cls):
            def fit(self, job_seed, n_chunks):
                with planted(name):
                    return super().fit(job_seed, n_chunks)

            def evaluate(self, centroids):
                with planted(name):
                    return super().evaluate(centroids)
        return Fault
    if name == "program_bf16x3":
        class Bf16x3(loop_cls):
            def __init__(self, config, mix, seed, device):
                super().__init__(config, {**mix, "precision": "bf16x3"}, seed,
                                 device)

            def evaluate(self, centroids):
                from repro_torch.kernels import ops

                ids, d = [], []
                for lo in range(0, self.X.shape[0], 262_144):
                    i, v = ops.assign(self.X[lo:lo + 262_144], centroids,
                                      precision="bf16x3")
                    ids.append(i)
                    d.append(v)
                return torch.cat(ids), float(torch.sum(torch.cat(d)))
        return Bf16x3
    precision = {"plain_tf32": "tf32", "plain_f32": "f32"}[name]

    class Plain(loop_cls):
        def fit(self, job_seed, n_chunks):
            c = self.config
            C, f, trace = plain.big_means(
                self.X, k=c["k"], s=c["s"], n_chunks=n_chunks, seed=job_seed,
                precision=precision, tol=c["tol"], max_iters=c["max_iters"],
                candidates=c["candidates"])
            return types.SimpleNamespace(
                centroids=C, objective=f, trace=trace, n_chunks=n_chunks,
                n_accepted=sum(a for _, _, a in trace), n_iterations=0)

        def evaluate(self, centroids):
            return plain.evaluate(self.X, centroids, precision)
    return Plain


FAULTS = ("fault_unchanged", "fault_half", "fault_id", "fault_accept")


@contextlib.contextmanager
def planted(name: str):
    """Fault ``name`` planted in the program while open: in
    ``repro_torch.kernels.ops``, or in the chunk step that the in-core
    strategies call (``repro_torch.engine.incore.chunk_step``)."""
    import torch
    from repro_torch.engine import incore
    from repro_torch.kernels import ops

    fused, assign, step = ops.fused_step, ops.assign, incore.chunk_step

    def unchanged(x, c, **kw):
        sums, counts, f = fused(x, c, **kw)
        return c * counts[:, None], counts, f

    def half(x, c, **kw):
        return fused(x[: x.shape[0] // 2], c, **kw)

    def altered(x, c, **kw):
        ids, d = assign(x, c, **kw)
        ids = ids.clone()
        ids[0] = (ids[0] + 1) % c.shape[0]
        return ids, d

    def keep_all(points, state, *args, **kw):
        # the incumbent's objective hidden: every chunk's solution is kept
        return step(points, state._replace(
            f_best=torch.full_like(state.f_best, float("inf"))), *args, **kw)

    patch = {"fault_unchanged": (ops, "fused_step", unchanged),
             "fault_half": (ops, "fused_step", half),
             "fault_id": (ops, "assign", altered),
             "fault_accept": (incore, "chunk_step", keep_all)}[name]
    setattr(*patch)
    try:
        yield
    finally:
        ops.fused_step, ops.assign, incore.chunk_step = fused, assign, step


def readings(cell: dict, seed: int, name: str, device) -> dict:
    """One seed's judged numbers under variant ``name``."""
    from perfbench import loops
    from perfbench.reference import judge

    cls = variant(loops.find(cell["mix"]["loop"]), name)
    loop = cls(cell["config"], cell["mix"], seed, device)
    t0 = time.monotonic()
    for _ in range(cell["mix"]["check_jobs"]):
        loop.job()
    numbers = loop.judge()
    f_true = loop.denominator()
    if f_true is not None and name == "program":
        numbers.update(judge.denominator_rel(loop.X, loop.means, f_true))
    if f_true is not None and name == "plain_f32":
        numbers.update(judge.denominator_rel(
            loop.X, loop.means, true_objective_f32(loop.X, loop.means)))
    return {"variant": name, "seed": seed, "numbers": numbers,
            "seconds": time.monotonic() - t0}


def true_objective_f32(X, means) -> float:
    """The benchmark's objective of the true means, in float32."""
    mu2 = (means * means).sum(1)
    total = 0.0
    for lo in range(0, X.shape[0], 1 << 16):
        x = X[lo:lo + (1 << 16)]
        d = (x * x).sum(1, keepdim=True) - 2.0 * (x @ means.T) + mu2[None]
        total += float(d.clamp_min_(0.0).min(1).values.sum())
    return total


SHRINK = {"m": 16384, "n": 64, "k": 48, "s": 2048, "n_chunks": 4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--variants",
                    default="plain_tf32,plain_f32,program_bf16x3")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", action="store_true",
                    help="the configuration at a size a CPU test holds")
    args = ap.parse_args(argv)

    import torch

    from perfbench import cells, harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = cells.load_cell(args.workload)
    if args.shrink:
        cell["config"].update(SHRINK)
    harness.prepare_program(device)
    jobs = [(int(s), "program") for s in args.seeds.split(",") if s]
    jobs += [(int(s), v) for s in args.control_seeds.split(",") if s
             for v in args.variants.split(",") if v]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, name in jobs:
            line = json.dumps({"workload": args.workload,
                               **readings(cell, seed, name, device)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
