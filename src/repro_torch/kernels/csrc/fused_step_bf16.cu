// Kernels A16 and A3: fused_step_bf16 / fused_step_bf16x3 — one Lloyd
// iteration's statistics in one pass, under the 'bf16' and 'bf16x3'
// precision policies.
//
// Replace the bf16 and bf16x3 bodies of the Pallas kernel
// repro/kernels/fused_step.py:fused_step_pallas with pipeline="blocks"
// (_fused_kernel, _tile_argmin, _fused_tile_accumulate).  For x [m,n] and
// f32 centroids c [k,n] they return kernel A's statistics
//   sums [k,n], counts [k], obj = sum_i max(best_i + ||x_i||^2, 0)
// with score_j = csq[j] - 2 dot(x, c_j), csq = ||c_j||^2 from the f32
// centroids (a first launch, common.cuh:sqnorm_rows) and ||x||^2 from the
// stored values:
//   A16: x stored bf16 (the wrapper casts it), c rounded to bf16, each dot
//        an f32 accumulation of exact bf16 products; sums of the bf16
//        values (common.cuh:Bf16Ops);
//   A3:  x stored f32, each dot (hh + hl) + lh of the bf16 hi / lo halves;
//        sums sum(x_hi) + sum(x_lo) per tile (common.cuh:Bf16x3Ops).
//
// Bound: bytes.  A16 reads x once at 2 bytes an element: at the main path's
// shapes (m = 64,000, k = 25, n = 28) 3.58 MB, 1.07 us at 3.35 TB/s, half of
// kernel A's bound.  A3 reads it at 4 bytes, as kernel A (7.17 MB, 2.14 us);
// its three bf16 products (3 x 2mkn = 269 MFLOP) take 0.27 us at the card's
// bf16 tensor-core peak.
// Design: kernel A's CTA body (common.cuh:fused_cta) under the policy, per-
// CTA partials reduced in CTA order by a third launch.  CUDA cores only (no
// tensor cores yet), no atomics: repeated launches are bitwise equal.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM, FUSED_MIN_CTAS)
fused_step_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ c,
                       const float* __restrict__ csq,
                       float* __restrict__ part, int64_t m, int k, int n,
                       int64_t num_tiles) {
  __shared__ TileSmemT<Bf16Ops> s;
  const int64_t stride = (int64_t)k * n + k + 1;
  fused_cta(s, x, c, part + blockIdx.x * stride, m, k, n, num_tiles, csq);
}

extern "C" __global__ void __launch_bounds__(TM)
fused_step_bf16x3_kernel(const float* __restrict__ x,
                         const float* __restrict__ c,
                         const float* __restrict__ csq,
                         float* __restrict__ part, int64_t m, int k, int n,
                         int64_t num_tiles) {
  __shared__ TileSmemT<Bf16x3Ops> s;
  const int64_t stride = (int64_t)k * n + k + 1;
  fused_cta(s, x, c, part + blockIdx.x * stride, m, k, n, num_tiles, csq);
}

extern "C" __global__ void fused_step_16_reduce(const float* __restrict__ part,
                                                float* __restrict__ out,
                                                int64_t stride, int G) {
  reduce_partials(part, out, stride, G);
}

// csq: scratch [k]; part: scratch [grid, k*n + k + 1];
// out: [k*n + k + 1] = sums (row-major) ++ counts ++ obj.
template <class X, class Kernel>
static int launch_fused_16(Kernel kernel, const X* x, const float* c,
                           float* csq, float* part, float* out, int64_t m,
                           int k, int n, int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t stride = (int64_t)k * n + k + 1;
  cudaStream_t st = (cudaStream_t)stream;
  sqnorm_rows<<<sqnorm_grid(k, n), 256, 0, st>>>(c, csq, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TM, 0, st>>>(x, c, csq, part, m, k, n, num_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_16_reduce<<<reduce_grid(stride), 256, 0, st>>>(part, out,
                                                            stride, grid);
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_step_bf16(const __nv_bfloat16* x, const float* c,
                                     float* csq, float* part, float* out,
                                     int64_t m, int k, int n, int grid,
                                     void* stream) {
  return launch_fused_16(fused_step_bf16_kernel, x, c, csq, part, out, m, k,
                         n, grid, stream);
}

extern "C" int repro_fused_step_bf16x3(const float* x, const float* c,
                                       float* csq, float* part, float* out,
                                       int64_t m, int k, int n, int grid,
                                       void* stream) {
  return launch_fused_16(fused_step_bf16x3_kernel, x, c, csq, part, out, m,
                         k, n, grid, stream);
}
