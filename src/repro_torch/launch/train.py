"""Clustering launcher (the paper's workload is training-like), the
reference's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch bigmeans_paper \
        --chunks 200 --scale 0.02 --ckpt /tmp/bigmeans_run [--device cpu]

Runs the streaming Big-means driver on a synthetic surrogate of the
configured stream.  Placement is declarative: ``--topology`` names the
spec (``single`` / ``stream_mesh`` / ``host_mesh``), and for ``host_mesh``
the ``--hosts/--coordinator/--rank`` flags (or the ``REPRO_*`` variables of
``repro_torch.engine.hostmesh.launch_local``) describe the process group —
launch one copy of this command per rank.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse

from repro_torch import device as devices
from repro_torch.api import BigMeansConfig, TopologySpec, fit
from repro_torch.data.synthetic import GMMSpec, gmm_chunk
from repro_torch.models.registry import get_config


def main(argv=None):
    """Parse the flags, fit, print the reference's two lines; returns the
    ``FitResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bigmeans_paper")
    ap.add_argument("--chunks", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.02,
                    help="scale factor on the configured stream size")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--time-budget", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--topology", default="auto",
                    choices=["auto", "single", "stream_mesh", "host_mesh"],
                    help="declarative placement (BigMeansConfig.topology)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="host_mesh: process-group size (else REPRO_NUM_HOSTS)")
    ap.add_argument("--coordinator", default=None,
                    help="host_mesh: coordinator host:port (else REPRO_COORD)")
    ap.add_argument("--rank", type=int, default=None,
                    help="host_mesh: this process's rank (else "
                         "REPRO_HOST_RANK)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    cfg = get_config(args.arch)
    if cfg.family != "cluster":
        raise AssertionError("use dryrun.py / examples for LM archs")
    m = max(int(cfg.m * args.scale), cfg.s * 2)
    spec = GMMSpec(m=m, n=cfg.n_features, components=cfg.k, spread=4.0,
                   seed=args.seed)

    if args.topology == "host_mesh":
        topology = TopologySpec(kind="host_mesh", hosts=args.hosts,
                                coordinator=args.coordinator, rank=args.rank)
    else:
        topology = args.topology
    rcfg = BigMeansConfig.from_workload(
        cfg, n_chunks=args.chunks, time_budget_s=args.time_budget,
        ckpt_dir=args.ckpt, seed=args.seed, topology=topology)

    print(f"[train] {args.arch}: m={m} n={cfg.n_features} k={rcfg.k} "
          f"s={rcfg.s} chunks={args.chunks} batch={rcfg.batch} "
          f"topology={rcfg.topology.kind}")
    result = fit(
        lambda cid: gmm_chunk(spec, cid, rcfg.s, device=dev), rcfg,
        method="streaming", n_features=cfg.n_features, device=dev)
    failed = result.extras.get("chunks_failed", 0)
    print(f"[train] done: f_best={result.objective:.6e} "
          f"accepted={result.n_accepted}/{result.n_chunks} "
          f"failed={failed} wall={result.wall_time_s:.1f}s "
          f"n_d={result.n_dist_evals:.3e}")
    return result


if __name__ == "__main__":
    main()
