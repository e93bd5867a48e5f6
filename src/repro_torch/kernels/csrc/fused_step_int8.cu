// Kernel A8: fused_step_int8 — one Lloyd iteration's statistics in one pass
// over an int8-quantized chunk.
//
// Replaces the int8 body of the Pallas kernel
// repro/kernels/fused_step.py:fused_step_pallas with pipeline="blocks"
// (the int8 branches of _tile_argmin and _fused_tile_accumulate).  For the
// chunk's codes xq [m,n] (per-feature scales scale [n]) and the centroids'
// codes cq [k,n] (per-row scales t [k]) and full-width centroids cf [k,n]
// f32 it returns
//   isums [k,n] = sum over rows of onehot(argmin_j score)^T xq   (int32)
//   counts [k]  = cluster sizes
//   obj         = sum_i max(best_i + ||deq(x_i)||^2, 0)
// with score_j = csq[j] - 2 (float(xq . cq_j) t[j]) (common.cuh,
// tile_argmin_q), csq = ||cf_j||^2 from a first launch (sqnorm_rows), and a
// strict '<' across centroids from a 1e30 best.  The wrapper turns isums
// into f32 data space (isums * scale) after the reduce, as
// fused_step.py:400-403 does.
//
// Bound: bytes.  One pass reads the codes once (mn bytes, a quarter of
// kernel A's); at the main path's shapes (m = 64,000, k = 25, n = 28) that
// is 1.79 MB, 0.54 us at 3.35 TB/s, against 2mkn = 89.6 M integer
// multiply-adds.  Design: kernel A's, on an int8 tile in shared memory
// (common.cuh:TileSmemQ): each CTA walks a fixed set of point tiles,
// scores them with int32 multiply-adds on the CUDA cores (no dp4a, no
// tensor cores yet), folds each tile into its own int32 partial sums, f32
// counts and objective by kernel A's sorted scatter (common.cuh:find_runs,
// tile_scatter), and a second launch reduces the partials in CTA order.  The int32 sums are exact, so any order gives the same integers;
// counts and objective are reduced in a fixed order, so repeated launches
// are bitwise equal.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
fused_step_int8_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ c,
                       const float* __restrict__ csq,
                       const float* __restrict__ tq,
                       const float* __restrict__ scale,
                       int32_t* __restrict__ psum, float* __restrict__ pf,
                       int64_t m, int k, int n, int64_t num_tiles) {
  __shared__ TileSmemQ s;
  const int64_t kn = (int64_t)k * n;
  fused_cta_q(s, x, c, csq, tq, scale, psum + blockIdx.x * kn,
              pf + blockIdx.x * ((int64_t)k + 1), m, k, n, num_tiles);
}

extern "C" __global__ void fused_step_int8_reduce(
    const int32_t* __restrict__ psum, const float* __restrict__ pf,
    int32_t* __restrict__ osum, float* __restrict__ of, int64_t kn, int k1,
    int G) {
  reduce_partials(psum, osum, kn, G);
  reduce_partials(pf, of, (int64_t)k1, G);
}

// cf: [k, n] f32 centroids; csq: scratch [k]; psum: scratch [grid, k*n]
// int32; pf: scratch [grid, k + 1] f32; osum: [k*n] int32 sums
// (row-major); of: [k + 1] = counts ++ obj.
extern "C" int repro_fused_step_int8(const int8_t* x, const int8_t* c,
                                     const float* cf, float* csq,
                                     const float* t, const float* scale,
                                     int32_t* psum, float* pf, int32_t* osum,
                                     float* of, int64_t m, int k, int n,
                                     int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t kn = (int64_t)k * n;
  cudaStream_t st = (cudaStream_t)stream;
  sqnorm_rows<<<sqnorm_grid(k, n), 256, 0, st>>>(cf, csq, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_int8_kernel<<<grid, TM, 0, st>>>(x, c, csq, t, scale, psum, pf,
                                              m, k, n, num_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_int8_reduce<<<reduce_grid(kn + k + 1), 256, 0, st>>>(
      psum, pf, osum, of, kn, k + 1, grid);
  return (int)cudaGetLastError();
}
