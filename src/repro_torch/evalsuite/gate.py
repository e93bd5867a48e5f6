"""The regression gate: fail the build when quality or speed regresses.

The reference's ``repro.evalsuite.gate``, ported as it is: diffs a fresh
suite document against a baseline document cell by cell, with per-metric
tolerances, and exits non-zero on regression.

What fails the gate (per (dataset, method) cell):

* ε regression — ``epsilon_mean`` rose more than ``--eps-tol``
  (absolute, in units of relative error: 0.05 = five points of ε);
* success-rate drop beyond ``--success-drop``;
* wall-time regression — ``wall_mean_s`` more than ``--wall-ratio``
  times the baseline's (cells faster than ``--wall-floor`` seconds are
  never wall-gated);
* a baseline cell missing from the fresh run, or either artifact
  failing schema validation.

What only warns: new cells not in the baseline (coverage grew), and ε
*improvements* beyond tolerance.

``--baseline`` has no default: the reference's committed baseline is a
CPU record of the reference, not of the port.

    PYTHONPATH=src python -m repro_torch.evalsuite.gate \
        --baseline base_suite.json --fresh BENCH_suite.json \
        [--report gate_report.txt]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.evalsuite import schema

DEFAULT_EPS_TOL = 0.05       # absolute increase in epsilon_mean
DEFAULT_SUCCESS_DROP = 0.5   # absolute drop in success_rate
DEFAULT_WALL_RATIO = 2.5     # fresh wall_mean_s / baseline wall_mean_s
DEFAULT_WALL_FLOOR = 0.5     # seconds; faster baseline cells aren't gated


@dataclasses.dataclass
class GateResult:
    failures: list = dataclasses.field(default_factory=list)
    warnings: list = dataclasses.field(default_factory=list)
    checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.failures

    def report(self) -> str:
        lines = [f"evalsuite gate: {self.checked} cell(s) compared"]
        for w in self.warnings:
            lines.append(f"  WARN  {w}")
        for f in self.failures:
            lines.append(f"  FAIL  {f}")
        lines.append("RESULT: " + ("PASS" if self.ok else
                                   f"FAIL ({len(self.failures)} regression(s))"))
        return "\n".join(lines)


def _cells(doc: dict) -> dict:
    return {(c["dataset"], c["method"]): c for c in doc["cells"]}


def compare(
    baseline: dict,
    fresh: dict,
    *,
    eps_tol: float = DEFAULT_EPS_TOL,
    success_drop: float = DEFAULT_SUCCESS_DROP,
    wall_ratio: float = DEFAULT_WALL_RATIO,
    wall_floor: float = DEFAULT_WALL_FLOOR,
    check_wall: bool = True,
) -> GateResult:
    """Diff two suite documents; tolerances are per-metric, per the module
    header.  Schema-validates both first: a malformed artifact is itself a
    gate failure, never a silent pass."""
    out = GateResult()
    for name, doc in (("baseline", baseline), ("fresh", fresh)):
        errors = schema.validate(doc, schema.SUITE_SCHEMA)
        if errors:
            out.failures.append(
                f"{name} artifact is schema-invalid: {errors[0]} "
                f"(+{len(errors) - 1} more)" if len(errors) > 1 else
                f"{name} artifact is schema-invalid: {errors[0]}")
    if out.failures:
        return out

    base_f_star = {d["name"]: d["f_star"] for d in baseline["datasets"]}
    for d in fresh["datasets"]:
        b = base_f_star.get(d["name"])
        if b is not None and d["f_star"] is not None and d["f_star"] != b:
            out.warnings.append(
                f"{d['name']}: f_star differs from baseline "
                f"({d['f_star']:.6g} vs {b:.6g}) — ε columns are not "
                "directly comparable; refresh the baseline")

    base_cells, fresh_cells = _cells(baseline), _cells(fresh)
    for key in sorted(set(fresh_cells) - set(base_cells)):
        out.warnings.append(f"{key[0]}/{key[1]}: new cell (not in baseline)")
    for key in sorted(base_cells):
        ds_name, method = key
        b = base_cells[key]
        f = fresh_cells.get(key)
        if f is None:
            out.failures.append(
                f"{ds_name}/{method}: cell missing from fresh run "
                "(coverage regressed)")
            continue
        out.checked += 1

        d_eps = f["epsilon_mean"] - b["epsilon_mean"]
        if d_eps > eps_tol:
            out.failures.append(
                f"{ds_name}/{method}: epsilon_mean "
                f"{b['epsilon_mean']:+.4f} -> {f['epsilon_mean']:+.4f} "
                f"(+{d_eps:.4f} > tol {eps_tol})")
        elif d_eps < -eps_tol:
            out.warnings.append(
                f"{ds_name}/{method}: epsilon_mean improved "
                f"{b['epsilon_mean']:+.4f} -> {f['epsilon_mean']:+.4f}; "
                "consider refreshing the committed baseline")
        if f["epsilon_min"] < 0:
            out.warnings.append(
                f"{ds_name}/{method}: run beat best-known f_star "
                f"(epsilon_min={f['epsilon_min']:+.4f}); update the "
                "registry f_star")

        drop = b["success_rate"] - f["success_rate"]
        if drop > success_drop:
            out.failures.append(
                f"{ds_name}/{method}: success_rate "
                f"{b['success_rate']:.2f} -> {f['success_rate']:.2f} "
                f"(drop {drop:.2f} > tol {success_drop})")

        if check_wall and b["wall_mean_s"] >= wall_floor:
            ratio = f["wall_mean_s"] / b["wall_mean_s"]
            if ratio > wall_ratio:
                out.failures.append(
                    f"{ds_name}/{method}: wall_mean_s "
                    f"{b['wall_mean_s']:.2f} -> {f['wall_mean_s']:.2f} "
                    f"({ratio:.2f}x > tol {wall_ratio}x)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff a fresh suite document against a baseline "
                    "document; non-zero exit on regression.")
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--fresh", default="BENCH_suite.json")
    ap.add_argument("--report", default=None,
                    help="also write the report to this file")
    ap.add_argument("--eps-tol", type=float, default=DEFAULT_EPS_TOL)
    ap.add_argument("--success-drop", type=float,
                    default=DEFAULT_SUCCESS_DROP)
    ap.add_argument("--wall-ratio", type=float, default=DEFAULT_WALL_RATIO)
    ap.add_argument("--wall-floor", type=float, default=DEFAULT_WALL_FLOOR)
    ap.add_argument("--no-wall", action="store_true",
                    help="skip wall-time gating (quality only)")
    args = ap.parse_args(argv)

    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.fresh) as f:
        fresh = json.load(f)
    result = compare(
        baseline, fresh,
        eps_tol=args.eps_tol, success_drop=args.success_drop,
        wall_ratio=args.wall_ratio, wall_floor=args.wall_floor,
        check_wall=not args.no_wall)
    report = result.report()
    print(report)
    if args.report:
        with open(args.report, "w") as f:
            f.write(report + "\n")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
