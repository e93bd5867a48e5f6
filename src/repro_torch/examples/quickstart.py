"""Quickstart: cluster a synthetic big-data stream through `repro_torch.api`,
the reference's ``examples/quickstart.py``.

One config, one ``fit()``: the execution strategy is a knob, and the paper's
§5 competitors answer through the same interface.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--m 200000] [--chunks 40] [--device cpu]

Runs on the card unless ``--device cpu``: the Big-means fit runs kernels A,
B and C, ``evaluate`` B, and the K-means++ baseline's Lloyd over all rows A,
B and C (its seeding is plain torch).
"""
from __future__ import annotations

import argparse

from repro_torch import device as devices
from repro_torch.api import BigMeansConfig, evaluate, fit
from repro_torch.data.synthetic import GMMSpec, gmm_dataset


def main(argv=None) -> dict:
    """Fit, evaluate and run the K-means++ baseline; print the reference's
    lines and return what they print, with the results behind them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=200_000, help="dataset rows")
    ap.add_argument("--chunks", type=int, default=40, help="chunk budget")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    # synthetic stream: args.m points, 16 features, 12 latent components
    X = gmm_dataset(GMMSpec(m=args.m, n=16, components=12, seed=0),
                    device=dev)
    cfg = BigMeansConfig(k=12, s=min(4000, args.m // 4), n_chunks=args.chunks)
    print(f"dataset: {tuple(X.shape)},  k={cfg.k},  chunk size s={cfg.s}")

    result = fit(X, cfg, device=dev)         # 'auto' picks the strategy
    print(f"strategy: {result.strategy},  chunks: {result.n_chunks}, "
          f"accepted improvements: {result.n_accepted}")
    full_nd = 2.0 * X.shape[0] * cfg.k * 20
    print(f"distance evaluations: {result.n_dist_evals:.3e} "
          f"(full K-means needs ~{full_nd:.3e} per run)")

    ids, f = evaluate(result, X, device=dev)
    print(f"Big-means    f(C, X) = {f:.6e}")

    # reference: multi-start K-means++ on the FULL dataset, same fit() call
    ref = fit(X, cfg, method="kmeanspp", seed=1, device=dev)
    print(f"K-means++    f(C, X) = {ref.objective:.6e} "
          f"({ref.n_iterations} Lloyd iterations over all {X.shape[0]} "
          "points)")
    return {"X": X, "config": cfg, "result": result, "ids": ids,
            "objective": f, "n_dist_evals": result.n_dist_evals,
            "full_kmeans_dist_evals": full_nd, "baseline": ref,
            "baseline_objective": ref.objective,
            "baseline_iterations": ref.n_iterations}


if __name__ == "__main__":
    main()
