"""Roofline terms and the fused-chunk traffic model on one NVIDIA H100.

The Big-means half of the reference's ``repro.launch.roofline``, with the
H100 SXM's published peaks in place of the TPU's:

    HBM3 bandwidth           3.35 TB/s
    fp32 outside the tensor cores   67 TFLOP/s   (kernels A and B: FFMA)
    bf16 tensor cores (dense)      989 TFLOP/s
    bf16x3 (three bf16 products a contraction)   989 / 3 TFLOP/s
    int8 tensor cores (dense)    1,979 TOP/s
    NVLink (per card)              900 GB/s

Terms:
    compute    = FLOPs / peak of the policy
    memory     = bytes / HBM bandwidth
    collective = collective bytes / NVLink bandwidth (0 on one card: the
                 port's runs on one card make no device collective)

``chunk_bytes`` and ``chunk_traffic`` are the reference's traffic model,
unchanged, so both packages count the same bytes and FLOPs for a chunk;
``model_flops`` is the reference's count of a zoo model's FLOPs at a shape.
:func:`main` projects chunk rates measured on the card onto these peaks.
"""
from __future__ import annotations

HBM_BW = 3.35e12
NVLINK_BW = 900e9
PEAK_FLOPS = {
    "f32": 67e12,
    "bf16": 989e12,
    "bf16x3": 989e12 / 3,
    "int8": 1979e12,
}


def roofline_terms(flops: float, nbytes: float, coll_bytes: float = 0.0,
                   *, precision: str = "f32") -> dict:
    """Compute, memory and collective seconds for one piece of work under
    ``precision``'s peak, the dominant term and the roofline fraction."""
    compute = flops / PEAK_FLOPS[precision]
    memory = nbytes / HBM_BW
    collective = coll_bytes / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    # "roofline fraction": useful compute time / achievable time if the
    # dominant term fully overlaps the others
    frac = compute / bound if bound > 0 else 0.0
    return {**terms, "dominant": dominant.replace("_s", ""),
            "bound_s": bound, "roofline_fraction": frac}


# ---------------------------------------------------------------------------
# Fused-chunk traffic model: FLOPs / streamed bytes per Big-means chunk
# ---------------------------------------------------------------------------

# Storage bytes per chunk element (int8 adds one f32 scale row per chunk,
# accounted separately in chunk_bytes).
_ITEMSIZE = {"f32": 4, "bf16": 2, "bf16x3": 4, "int8": 1}


def chunk_bytes(s: int, n: int, precision: str) -> int:
    """Bytes to stream one ``[s, n]`` chunk once under ``precision``.

    int8 ships the quantized payload (int8 codes + one f32 per-feature
    scale row); the float policies ship the raw array.
    """
    b = s * n * _ITEMSIZE[precision]
    if precision == "int8":
        b += 4 * n
    return b


def chunk_traffic(s: int, n: int, k: int, precision: str,
                  passes: float) -> dict:
    """FLOPs and streamed bytes for one chunk's fused Lloyd loop.

    ``passes`` = lloyd_iters + 2 (the fused loop re-reads the chunk every
    iteration; the acceptance epilogue adds an assign + update pass).
    Per pass: the distance contraction (2*s*k*n), the norm/argmin
    assembly (~3*s*k) and the one-hot update contraction (2*s*k*n) —
    ~4*s*k*n FLOPs; bytes are the chunk stream plus the (small) centroid
    read and sums/counts write-back, all f32 regardless of policy.
    """
    flops_pass = 4.0 * s * k * n + 3.0 * s * k
    bytes_pass = chunk_bytes(s, n, precision) + 2 * (4 * k * n) + 4 * k
    return {
        "flops": flops_pass * passes,
        "bytes": bytes_pass * passes,
        "bytes_per_chunk": chunk_bytes(s, n, precision),
    }


def precision_roofline(row: dict) -> dict:
    """Roofline terms + achieved-vs-peak bandwidth for one measured row:
    ``s``, ``n``, ``k``, ``precision``, ``batch``, ``chunks_per_s`` and
    ``lloyd_iters_per_chunk`` (the reference's ``BENCH_precision`` row
    keys).  An achieved share above 1 means the model counts too few
    bytes."""
    s, n, k = row["s"], row["n"], row["k"]
    passes = row.get("lloyd_iters_per_chunk", 0.0) + 2
    traffic = chunk_traffic(s, n, k, row["precision"], passes)
    terms = roofline_terms(traffic["flops"], traffic["bytes"], 0.0,
                           precision=row["precision"])
    achieved = row["chunks_per_s"] * traffic["bytes"]
    return {
        "precision": row["precision"],
        "batch": row["batch"],
        "k": k, "n": n, "s": s,
        "passes": round(passes, 2),
        "model_flops_per_chunk": traffic["flops"],
        "model_bytes_per_chunk": traffic["bytes"],
        "bytes_per_chunk_stream": traffic["bytes_per_chunk"],
        "chunks_per_s": row["chunks_per_s"],
        "achieved_bytes_per_s": round(achieved, 1),
        "peak_bytes_per_s": HBM_BW,
        "achieved_frac_of_peak": round(achieved / HBM_BW, 8),
        "arithmetic_intensity": round(
            traffic["flops"] / traffic["bytes"], 3),
        **terms,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params:
    a zoo config (``repro_torch.models.config.ModelConfig``) at one of
    ``repro_torch.configs.shapes.SHAPES``."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def main(argv=None) -> None:
    """Project measured chunk rates onto the H100's roofline.

    ``--bench`` is a JSON file ``{"rows": [...]}`` of rows in the keys
    :func:`precision_roofline` reads (``chip_smoke.py`` writes the rates
    of its HEPMASS fits so); it is required: the port has no committed
    rates of its own and never reads the reference's TPU file.  Writes a
    ``repro.bench/1`` envelope (``repro_torch.evalsuite.schema``) with the
    H100 peaks and the card's name and power limit (``--device cpu`` for a
    run without a card: the host then names the CPU).
    """
    import argparse
    import json
    import os

    from repro_torch.evalsuite import schema as bench_schema

    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", required=True,
                    help="JSON file of measured rows ({'rows': [...]})")
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--device", default=None,
                    help="'cpu' to record the CPU as the host")
    args = ap.parse_args(argv)

    with open(args.bench) as f:
        bench = json.load(f)
    rows = [precision_roofline(r) for r in bench["rows"]]
    f32 = {r["batch"]: r for r in rows if r["precision"] == "f32"}
    for r in rows:
        twin = f32.get(r["batch"])
        if twin:
            r["bytes_ratio_vs_f32"] = round(
                r["model_bytes_per_chunk"] / twin["model_bytes_per_chunk"],
                4)
    d = os.path.dirname(args.out)
    if d:
        os.makedirs(d, exist_ok=True)
    out = bench_schema.write_bench(
        args.out,
        bench_schema.envelope(
            "precision_roofline", rows,
            host=bench_schema.host_info(args.device),
            source=os.path.basename(args.bench),
            peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, nvlink_bw=NVLINK_BW,
            traffic_model="per pass: 4*s*k*n + 3*s*k FLOPs; "
                          "chunk_bytes(precision) + 2*4*k*n + 4*k bytes; "
                          "passes = lloyd_iters_per_chunk + 2",
        ))
    for r in rows:
        print(f"prec={r['precision']:6s} batch={r['batch']:<3d} "
              f"AI={r['arithmetic_intensity']:6.2f} flop/byte  "
              f"dominant={r['dominant']:7s} "
              f"bytes/chunk={r['model_bytes_per_chunk']:.3e}  "
              f"achieved/peak={r['achieved_frac_of_peak']:.2e}")
    print(f"# wrote {out}")


if __name__ == "__main__":
    main()
