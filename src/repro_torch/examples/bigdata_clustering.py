"""End to end: out-of-core Big-means with checkpoints and restart,
entirely through `repro_torch.api`; the reference's
``examples/bigdata_clustering.py``.

Streams a virtual 8M x 28 dataset (HEPMASS-scale surrogate) through the
streaming strategy for a few hundred chunks, checkpoints along the way,
simulates a crash + restart, and finishes with the full assignment pass.

    PYTHONPATH=src python -m repro_torch.examples.bigdata_clustering \
        [--chunks 300] [--device cpu]

Runs on the card unless ``--device cpu``: each chunk is generated there and
handed to the API as a host array, as the reference's provider does; the
streamed fits run kernels A, B and C, the final pass B.
``--topology host_mesh`` reads the ``REPRO_COORD`` / ``REPRO_NUM_HOSTS`` /
``REPRO_HOST_RANK`` variables that
:func:`repro_torch.engine.hostmesh.launch_local` sets.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch import device as devices
from repro_torch.api import BigMeansConfig, evaluate, fit
from repro_torch.data.synthetic import GMMSpec, gmm_chunk

SPEC = GMMSpec(m=8_000_000, n=28, components=25, spread=4.0, seed=17)


def main(argv=None) -> dict:
    """Phase 1, the restart, the final pass; print the reference's lines
    and return what they print, with the results behind them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=300)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--s", type=int, default=8192, help="chunk size")
    ap.add_argument("--topology", default="auto",
                    choices=["auto", "single", "stream_mesh", "host_mesh"],
                    help="declarative placement spec; host_mesh reads the "
                         "REPRO_COORD/REPRO_NUM_HOSTS/REPRO_HOST_RANK env "
                         "vars set by the multi-process launcher")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)

    def provider(chunk_id: int) -> np.ndarray:
        """Fetch one chunk of the virtual dataset (never materialized)."""
        return devices.host_array(gmm_chunk(SPEC, chunk_id, args.s,
                                            device=dev), np.float32)

    ckpt = os.path.join(tempfile.gettempdir(), "bigmeans_demo_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)      # deterministic demo reruns
    cfg = BigMeansConfig(
        k=args.k, s=args.s, n_chunks=args.chunks, topology=args.topology,
        ckpt_dir=ckpt, ckpt_every=50, log_every=25, seed=0)

    print(f"phase 1: clustering {args.chunks // 2} chunks, then 'crashing'…")
    r1 = fit(provider, cfg.replace(n_chunks=args.chunks // 2, resume=False),
             method="streaming", n_features=SPEC.n, device=dev)
    print(f"  f_best={r1.objective:.5e}  accepted={r1.n_accepted}  "
          f"wall={r1.wall_time_s:.1f}s")

    print("phase 2: restart from checkpoint, finish the budget…")
    r2 = fit(provider, cfg, method="streaming", n_features=SPEC.n,
             device=dev)
    print(f"  f_best={r2.objective:.5e}  accepted={r2.n_accepted}  "
          f"chunks_done={r2.n_chunks} (resumed)  wall={r2.wall_time_s:.1f}s")
    for entry in r2.trace:
        if entry[0] == "fetch_error":
            print(f"    chunk {entry[1]:4d}: FETCH FAILED {entry[2]}")
        else:
            cid, fb, fn = entry
            print(f"    chunk {cid:4d}: incumbent {fb:.5e}  "
                  f"candidate {fn:.5e}")

    print("final pass: assigning a 1M-point sample to the centroids…")
    n_sample = max(1, 1_000_000 // args.s)
    sample = np.concatenate([provider(10_000 + i) for i in range(n_sample)])
    ids, f = evaluate(r2, sample, device=dev)
    sizes = np.bincount(ids.cpu().numpy(), minlength=args.k)
    per_point = float(f) / len(sample)
    print(f"  f(C, sample)/point = {per_point:.4f}")
    print(f"  cluster sizes: min={sizes.min()} median={int(np.median(sizes))} "
          f"max={sizes.max()}")
    return {"config": cfg, "phase1": r1, "phase2": r2, "ckpt_dir": ckpt,
            "sample": sample, "sample_rows": len(sample), "ids": ids,
            "objective": float(f), "per_point": per_point, "sizes": sizes}


if __name__ == "__main__":
    main()
