// Kernel D: fused_step_batched_f32 — one Lloyd iteration's statistics for B
// independent streams in one launch.
//
// Replaces the Pallas kernel
// repro/kernels/fused_step.py:fused_step_batched_pallas
// (_fused_batched_kernel, _fused_tile_accumulate, _tile_argmin), f32 body.
// For x [B,m,n] and c [B,k,n] it returns, for every stream b, kernel A's
// statistics of (x[b], c[b]):
//   sums [B,k,n], counts [B,k], obj [B]
// with score_j = ||c_j||^2 - 2 x.c_j by sequential FMAs, a strict '<' over
// centroids from a 1e30 best, obj += max(best + ||x||^2, 0), and the
// deterministic sorted scatter of each tile into per-CTA partials.
//
// Bound: bytes.  It reads x once (4Bmn bytes); at the batched main path's
// shapes (B = 8, m = 64,000, k = 25, n = 28) that is 57.3 MB, 17.1 us at
// 3.35 TB/s, against 2Bmkn = 717 MFLOP (~12 flop per byte, below the card's
// fp32 ratio of ~20).
// Design: a 2-D grid (CTA, stream).  Each stream gets exactly kernel A's CTA
// partition of its chunk (the per-stream grid is the one the wrapper gives
// kernel A for that m, k, n) and runs kernel A's CTA body
// (common.cuh:fused_cta) on per-stream base pointers; a second launch adds
// each stream's per-CTA partials in CTA order.  So stream b is bitwise
// equal to kernel A on (x[b], c[b]), and repeated launches are bitwise
// equal.  The Pallas kernel keeps a stream's sums resident across its
// sequential point-tile grid; here the streams' CTAs run in parallel and
// the partials take the place of that carry.  fp32 FMAs only: no tensor
// cores, no TF32, no atomics.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM, FUSED_MIN_CTAS)
fused_step_batched_f32_kernel(const float* __restrict__ x,
                              const float* __restrict__ c,
                              float* __restrict__ part, int64_t m, int k,
                              int n, int64_t num_tiles) {
  __shared__ TileSmem s;
  const int64_t stride = (int64_t)k * n + k + 1;
  const int64_t b = blockIdx.y;
  fused_cta(s, x + b * m * n, c + b * k * n,
            part + (b * gridDim.x + blockIdx.x) * stride, m, k, n, num_tiles);
}

extern "C" __global__ void fused_step_batched_f32_reduce(
    const float* __restrict__ part, float* __restrict__ out, int64_t stride,
    int G) {
  const int64_t b = blockIdx.y;
  reduce_partials(part + b * G * stride, out + b * stride, stride, G);
}

// x [batch,m,n], c [batch,k,n]; part: scratch [batch, grid, k*n + k + 1];
// out: [batch, k*n + k + 1], each row sums (row-major) ++ counts ++ obj.
// `grid` CTAs per stream.
extern "C" int repro_fused_step_batched_f32(const float* x, const float* c,
                                            float* part, float* out,
                                            int batch, int64_t m, int k, int n,
                                            int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t stride = (int64_t)k * n + k + 1;
  cudaStream_t st = (cudaStream_t)stream;
  fused_step_batched_f32_kernel<<<dim3(grid, batch), TM, 0, st>>>(
      x, c, part, m, k, n, num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_batched_f32_reduce<<<dim3(reduce_grid(stride), batch), 256, 0,
                                  st>>>(part, out, stride, grid);
  return (int)cudaGetLastError();
}
