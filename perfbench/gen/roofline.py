"""Work counts and peaks for the roofline shares.

``chunk_bytes`` and ``chunk_traffic`` are frozen copies of
``repro_torch.launch.roofline``'s traffic model.  The shares do not take
its FLOPs whole: it counts the centroid update as a one-hot contraction
(2*s*k*n), and the update needs only the s*n adds of a scatter, so a share
on that count would pass 100 % as soon as the update is a scatter (kernel C
is).  The functions below count what the algorithm needs, whatever kernel
does it: the distances (2*s*k*n) and their assembly and argmin (3*s*k) of
each assignment, the s*n adds of each update, and the bytes of the frozen
model, each input read once and each output written once per launch.

Peaks: one NVIDIA H100 SXM, dense, at a 700 W power limit (NVIDIA's data
sheet).  ``COMPUTE_PEAK`` gives, for each precision a configuration states,
the highest published rate of an arithmetic route whose results the cells'
``correct`` comparison accepts (``PERF.md`` §2 gives the readings).
"""
from __future__ import annotations

HBM_BW = 3.35e12
PEAK_FLOPS = {
    "f32": 67e12,           # FP32 outside the tensor cores
    "tf32": 495e12,         # tensor cores
    "bf16": 989e12,         # tensor cores
    "bf16x3": 989e12 / 3,   # three bf16 products a contraction
    "int8": 1979e12,
}
COMPUTE_PEAK = {"f32": PEAK_FLOPS["bf16x3"]}

# --- frozen copy of repro_torch.launch.roofline (chunk traffic model) -----
_ITEMSIZE = {"f32": 4, "bf16": 2, "bf16x3": 4, "int8": 1}


def chunk_bytes(s: int, n: int, precision: str) -> int:
    b = s * n * _ITEMSIZE[precision]
    if precision == "int8":
        b += 4 * n
    return b


def chunk_traffic(s: int, n: int, k: int, precision: str,
                  passes: float) -> dict:
    flops_pass = 4.0 * s * k * n + 3.0 * s * k
    bytes_pass = chunk_bytes(s, n, precision) + 2 * (4 * k * n) + 4 * k
    return {
        "flops": flops_pass * passes,
        "bytes": bytes_pass * passes,
        "bytes_per_chunk": chunk_bytes(s, n, precision),
    }
# --- end of the frozen copy ------------------------------------------------


def assign_work(rows: int, n: int, k: int) -> tuple[float, float]:
    """(FLOPs, bytes) of assigning ``rows`` f32 rows to k centroids: the
    rows and centroids read, an id and a distance written a row."""
    return (2.0 * rows * k * n + 3.0 * rows * k,
            float(chunk_bytes(rows, n, "f32") + 4 * k * n + 8 * rows))


def lloyd_iteration_work(s: int, n: int, k: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one Lloyd iteration on an [s, n] f32 chunk: the
    assignment, then the sums (s*n adds) and counts; the frozen model's
    bytes (the chunk, the centroids read, sums and counts written)."""
    flops = 2.0 * s * k * n + 3.0 * s * k + 1.0 * s * n
    nbytes = chunk_bytes(s, n, "f32") + 2 * (4 * k * n) + 4 * k
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    return max(flops / peak_flops, nbytes / HBM_BW)


def fit_least_seconds(*, s: int, n: int, k: int, n_chunks: int,
                      n_iterations: int, peak_flops: float) -> float:
    """The least time of one fit's Lloyd work: ``n_iterations`` iterations
    over its chunks, and each chunk's closing assignment and update."""
    it = least_seconds(*lloyd_iteration_work(s, n, k), peak_flops)
    a_flops, a_bytes = assign_work(s, n, k)
    upd = least_seconds(1.0 * s * n,
                        float(chunk_bytes(s, n, "f32") + 4 * s
                              + 4 * k * n + 4 * k), peak_flops)
    return (n_iterations * it
            + n_chunks * (least_seconds(a_flops, a_bytes, peak_flops) + upd))


def evaluate_least_seconds(*, m: int, n: int, k: int,
                           peak_flops: float) -> float:
    """The least time of assigning all m rows once."""
    return least_seconds(*assign_work(m, n, k), peak_flops)
