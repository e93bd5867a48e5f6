"""Serving demo: train, register, serve concurrent clients, hot-swap; the
reference's ``examples/serve_assignments.py`` on `repro_torch.api`.

The paper's end product is a centroid set; its value is realized at
assignment time, and point-to-centroid lookup is itself a streaming
workload.  This example runs the whole lifecycle through the public API:

1. **train** — a checkpointed streaming Big-means fit;
2. **serve** — register the result with ``repro_torch.api.serve()``:
   concurrent client threads submit small point batches, the batching
   frontend coalesces them into padded power-of-two launches (one CUDA
   graph a bucket, captured at warmup: zero captures after it);
3. **hot-swap** — a :class:`CheckpointWatcher` polls the checkpoint
   directory; training continues mid-traffic and the watcher atomically
   swaps the improved centroids in without dropping a single request.

    PYTHONPATH=src python -m repro_torch.examples.serve_assignments
    PYTHONPATH=src python -m repro_torch.examples.serve_assignments \
        --chunks 24 --clients 4 --requests 30        # CI-sized
    ... --device cpu                                 # the plain path

Runs on the card unless ``--device cpu``: the fits run kernels A, B and C
on the default stream while the server replays B's graphs on its own.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import threading

import numpy as np

from repro_torch import device as devices
from repro_torch.api import BigMeansConfig, ServeConfig, fit, serve
from repro_torch.data.synthetic import GMMSpec, gmm_chunk

SPEC = GMMSpec(m=1_000_000, n=12, components=10, seed=5)


def main(argv=None) -> dict:
    """Train, serve under client threads while training goes on, print the
    reference's lines; return what they print, with the results behind
    them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=40,
                    help="chunks for the initial training stage")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=60,
                    help="requests per client")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    def provider(chunk_id: int) -> np.ndarray:
        """One 4,096-row chunk, generated on the card (or the CPU), as a
        host array."""
        return devices.host_array(gmm_chunk(SPEC, chunk_id, 4096, device=dev),
                                  np.float32)

    # -- train: checkpointed streaming fit through the facade ---------------
    ckpt = os.path.join(tempfile.gettempdir(), "bigmeans_serve_ckpt")
    cfg = BigMeansConfig(k=10, s=4096, n_chunks=args.chunks, ckpt_dir=ckpt,
                         ckpt_every=max(1, args.chunks // 2), seed=0,
                         resume=False)
    result = fit(provider, cfg, method="streaming", n_features=SPEC.n,
                 device=dev)
    print(f"trained: {result.summary()}")

    # -- serve: concurrent clients against the registered model ------------
    serve_cfg = ServeConfig(min_bucket=64, max_batch=1024, max_linger_ms=2.0)
    rng = np.random.default_rng(0)
    done = []

    with serve({"gmm": result}, serve_cfg, device=dev) as srv:
        watcher = srv.watch("gmm", ckpt, poll_interval_s=0.05)

        def client(cid: int) -> None:
            n_ok, versions = 0, set()
            for req in range(args.requests):
                batch = provider(50_000 + cid * args.requests + req)
                batch = batch[: int(rng.integers(32, 256))]
                resp = srv.assign("gmm", batch)
                versions.add(resp.version)
                n_ok += 1
            done.append((cid, n_ok, versions))

        threads = [threading.Thread(target=client, args=(cid,), daemon=True)
                   for cid in range(args.clients)]
        for t in threads:
            t.start()

        # -- hot-swap: training continues while traffic flows ---------------
        more = fit(provider, cfg, method="streaming", n_features=SPEC.n,
                   resume=True, n_chunks=args.chunks * 2, device=dev)
        print(f"retrained: {more.summary()}")

        for t in threads:
            t.join()

        stats = srv.stats("gmm")
        recompiles = stats["recompiles"] - len(serve_cfg.buckets())
        print(f"served {stats['n_requests']} requests in "
              f"{stats['n_batches']} launches "
              f"({stats['requests_per_batch']:.2f} req/launch): "
              f"p50={stats.get('p50_ms', 0):.2f}ms "
              f"p99={stats.get('p99_ms', 0):.2f}ms")
        print(f"recompiles after warmup: {recompiles} "
              f"(buckets: {serve_cfg.buckets()})")
        print(f"hot-swaps applied: {watcher.n_swaps} "
              f"(serving step {stats['step']}); trace: {srv.trace}")
        trace = list(srv.trace)

    total = sum(n for _, n, _ in done)
    versions = set().union(*(v for _, _, v in done))
    assert total == args.clients * args.requests, "dropped requests!"
    print(f"all {total} client requests completed; "
          f"centroid versions observed: {sorted(versions)}")
    return {"trained": result, "retrained": more, "stats": stats,
            "recompiles_after_warmup": recompiles,
            "buckets": serve_cfg.buckets(), "n_swaps": watcher.n_swaps,
            "trace": trace, "completed": total, "versions": sorted(versions),
            "ckpt_dir": ckpt}


if __name__ == "__main__":
    main()
