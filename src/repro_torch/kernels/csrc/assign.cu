// Kernel B: assign_f32 — nearest-centroid assignment in true fp32.
//
// Replaces the Pallas kernel repro/kernels/distance.py:assign_pallas
// (_assign_kernel).  For x [m,n] and c [k,n] (row-major fp32) it writes
//   ids[i] = argmin_j (||c_j||^2 - 2 x_i.c_j)   (ties: lowest j)
//   d[i]   = max(min_j(...) + ||x_i||^2, 0)
// with the score, the tie rule and the 1e30 initial best of
// distance.py:65,83-93.
//
// Bound: bytes.  It reads x once (4mn bytes), c once per CTA (L2) and writes
// 8m bytes; at the main path's shapes (m = 64,000 or 262,144-row evaluate
// batches, k = 25, n = 28) that is ~0.3 flop per byte, far below the card's
// fp32 ratio.  Design: one thread per point, the point tile staged through
// shared memory with coalesced loads, centroids k-tiled in shared memory
// and the KT scores of a k tile held in registers (common.cuh:assign_cta,
// tile_argmin).
// fp32 FMAs only: no tensor cores, no TF32.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
assign_f32_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  int32_t* __restrict__ ids, float* __restrict__ d, int64_t m,
                  int k, int n, int64_t num_tiles) {
  __shared__ TileSmem s;
  assign_cta(s, x, c, ids, d, m, k, n, num_tiles);
}

extern "C" int repro_assign_f32(const float* x, const float* c, int32_t* ids,
                                float* d, int64_t m, int k, int n, int grid,
                                void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  if (num_tiles > 0) {
    assign_f32_kernel<<<grid, TM, 0, (cudaStream_t)stream>>>(
        x, c, ids, d, m, k, n, num_tiles);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
