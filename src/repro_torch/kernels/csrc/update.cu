// Kernel C: update_f32 — per-cluster sums and counts in fp32.
//
// Replaces the Pallas kernel repro/kernels/update.py:update_pallas
// (_update_kernel).  For x [m,n] fp32 and ids [m] int32 it computes
//   sums[j, f] = sum_{i : ids_i == j} x[i, f],   counts[j] = #{i : ids_i == j}
// where an id outside [0, k) adds nothing.
//
// Bound: bytes.  It reads x and ids once (4mn + 4m bytes) and writes
// 4(kn + k); at the main path's shapes (m = 64,000, k = 25, n = 28) that is
// about 7.4 MB.  Design: the one-hot contraction of the TPU kernel, kept
// deterministic without atomics — each CTA walks a fixed set of point
// tiles, and each thread owns a fixed set of (cluster, feature) elements of
// the CTA's partial sums, which it adds up over the tile's rows in order
// (common.cuh:update_cta, tile_accumulate).  A second launch reduces the
// per-CTA partials in CTA order.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
update_f32_kernel(const float* __restrict__ x, const int32_t* __restrict__ ids,
                  float* __restrict__ part, int64_t m, int k, int n,
                  int64_t num_tiles) {
  __shared__ TileSmem s;
  const int64_t stride = (int64_t)k * n + k;
  update_cta(s, x, ids, part + blockIdx.x * stride, m, k, n, num_tiles);
}

extern "C" __global__ void update_f32_reduce(const float* __restrict__ part,
                                             float* __restrict__ out,
                                             int64_t stride, int G) {
  reduce_partials(part, out, stride, G);
}

// part: scratch [grid, k*n + k]; out: [k*n + k] = sums (row-major) ++ counts.
extern "C" int repro_update_f32(const float* x, const int32_t* ids,
                                float* part, float* out, int64_t m, int k,
                                int n, int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t stride = (int64_t)k * n + k;
  cudaStream_t st = (cudaStream_t)stream;
  update_f32_kernel<<<grid, TM, 0, st>>>(x, ids, part, m, k, n, num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_f32_reduce<<<reduce_grid(stride), 256, 0, st>>>(part, out, stride,
                                                         grid);
  return (int)cudaGetLastError();
}
