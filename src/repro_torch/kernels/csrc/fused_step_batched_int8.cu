// Kernel D8: fused_step_batched_int8 — one Lloyd iteration's statistics for
// B independent int8-quantized streams in one launch.
//
// Replaces the int8 body of the Pallas kernel
// repro/kernels/fused_step.py:fused_step_batched_pallas
// (_fused_batched_kernel with precision="int8").  For the codes xq [B,m,n]
// with one scale row per stream, scale [B,n], and the per-stream centroid
// codes cq [B,k,n], row scales t [B,k] and full-width centroids cf [B,k,n]
// f32 (norms csq [B,k] from a first launch, sqnorm_rows), it returns, for
// every stream b, kernel A8's statistics of stream b:
//   isums [B,k,n] (int32), counts [B,k], obj [B]
// The wrapper scales isums[b] by scale[b] after the reduce
// (fused_step.py:506-510).
//
// Bound: bytes.  It reads the codes once (Bmn bytes); at the batched main
// path's shapes (B = 8, m = 64,000, k = 25, n = 28) that is 14.3 MB,
// 4.3 us at 3.35 TB/s.  Design: kernel D's, on kernel A8's CTA body
// (common.cuh:fused_cta_q): a 2-D grid (CTA, stream) in which each stream
// gets exactly kernel A8's CTA partition of its chunk and runs kernel A8's
// code on per-stream base pointers; a second launch reduces each stream's
// partials in CTA order.  So stream b is bitwise equal to kernel A8 on
// stream b, and repeated launches are bitwise equal.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
fused_step_batched_int8_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ c,
                               const float* __restrict__ csq,
                               const float* __restrict__ tq,
                               const float* __restrict__ scale,
                               int32_t* __restrict__ psum,
                               float* __restrict__ pf, int64_t m, int k,
                               int n, int64_t num_tiles) {
  __shared__ TileSmemQ s;
  const int64_t kn = (int64_t)k * n;
  const int64_t b = blockIdx.y;
  const int64_t cta = b * gridDim.x + blockIdx.x;
  fused_cta_q(s, x + b * m * n, c + b * kn, csq + b * k, tq + b * k,
              scale + b * n, psum + cta * kn, pf + cta * ((int64_t)k + 1), m,
              k, n, num_tiles);
}

extern "C" __global__ void fused_step_batched_int8_reduce(
    const int32_t* __restrict__ psum, const float* __restrict__ pf,
    int32_t* __restrict__ osum, float* __restrict__ of, int64_t kn, int k1,
    int G) {
  const int64_t b = blockIdx.y;
  reduce_partials(psum + b * G * kn, osum + b * kn, kn, G);
  reduce_partials(pf + b * G * k1, of + b * k1, (int64_t)k1, G);
}

// x [batch,m,n], c / cf [batch,k,n], t [batch,k], scale [batch,n]; csq:
// scratch [batch,k]; psum: scratch [batch, grid, k*n] int32; pf: scratch
// [batch, grid, k + 1]; osum: [batch, k*n] int32; of: [batch, k + 1] =
// counts ++ obj per stream.  `grid` CTAs per stream.
extern "C" int repro_fused_step_batched_int8(
    const int8_t* x, const int8_t* c, const float* cf, float* csq,
    const float* t, const float* scale, int32_t* psum, float* pf,
    int32_t* osum, float* of, int batch, int64_t m, int k, int n, int grid,
    void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t kn = (int64_t)k * n;
  const int64_t rows = (int64_t)batch * k;
  cudaStream_t st = (cudaStream_t)stream;
  sqnorm_rows<<<sqnorm_grid(rows, n), 256, 0, st>>>(cf, csq, rows, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_batched_int8_kernel<<<dim3(grid, batch), TM, 0, st>>>(
      x, c, csq, t, scale, psum, pf, m, k, n, num_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_batched_int8_reduce<<<dim3(reduce_grid(kn + k + 1), batch), 256,
                                   0, st>>>(psum, pf, osum, of, kn, k + 1,
                                            grid);
  return (int)cudaGetLastError();
}
