// Kernel A: fused_step_f32 — one Lloyd iteration's statistics in one pass.
//
// Replaces the Pallas kernel repro/kernels/fused_step.py:fused_step_pallas
// with pipeline="blocks" (_fused_kernel, _tile_argmin,
// _fused_tile_accumulate), f32 body.  For x [m,n] and c [k,n] it returns
//   sums [k,n]  = sum over rows of onehot(argmin_j score)^T x
//   counts [k]  = cluster sizes
//   obj         = sum_i max(best_i + ||x_i||^2, 0)
// with score_j = ||c_j||^2 - 2 x.c_j, a strict '<' across centroids (ties
// go to the lowest index) and a 1e30 initial best.
//
// Bound: bytes.  One pass reads x once (4mn bytes); c, the outputs and the
// per-CTA partials are small.  At the main path's shapes (m = 64,000,
// k = 25, n = 28) that is 7.17 MB read for 2mkn = 89.6 MFLOP, ~12 flop per
// byte against the card's fp32 (non-tensor) ratio of ~20: memory-bound.
// Design: each CTA walks a fixed set of point tiles; per tile it computes
// the argmin of each row with the point tile and a centroid tile in shared
// memory (common.cuh:tile_argmin), then folds the tile into its own partial
// sums, counts and objective by a sorted scatter: the tile's rows sorted
// into runs of one cluster in shared memory (common.cuh:find_runs), each
// run's rows summed in row order by one thread a feature
// (common.cuh:tile_scatter), while the tile is still resident when n <= 32.
// That is O(TM n) work a tile where the one-hot contraction the kernel
// took before was O(TM k n), and bitwise its result.  A second launch
// reduces the per-CTA partials in CTA order.  No float atomics anywhere,
// so repeated launches are bitwise equal.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM, FUSED_MIN_CTAS)
fused_step_f32_kernel(const float* __restrict__ x, const float* __restrict__ c,
                      float* __restrict__ part, int64_t m, int k, int n,
                      int64_t num_tiles) {
  __shared__ TileSmem s;
  const int64_t stride = (int64_t)k * n + k + 1;
  fused_cta(s, x, c, part + blockIdx.x * stride, m, k, n, num_tiles);
}

extern "C" __global__ void fused_step_f32_reduce(const float* __restrict__ part,
                                                 float* __restrict__ out,
                                                 int64_t stride, int G) {
  reduce_partials(part, out, stride, G);
}

// part: scratch [grid, k*n + k + 1];
// out: [k*n + k + 1] = sums (row-major) ++ counts ++ obj.
extern "C" int repro_fused_step_f32(const float* x, const float* c,
                                    float* part, float* out, int64_t m, int k,
                                    int n, int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t stride = (int64_t)k * n + k + 1;
  cudaStream_t st = (cudaStream_t)stream;
  fused_step_f32_kernel<<<grid, TM, 0, st>>>(x, c, part, m, k, n, num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_f32_reduce<<<reduce_grid(stride), 256, 0, st>>>(part, out,
                                                             stride, grid);
  return (int)cudaGetLastError();
}
