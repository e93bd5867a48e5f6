// Kernels D16 and D3: fused_step_batched_bf16 / fused_step_batched_bf16x3 —
// one Lloyd iteration's statistics for B streams in one launch, under the
// 'bf16' and 'bf16x3' precision policies.
//
// Replace the bf16 and bf16x3 bodies of the Pallas kernel
// repro/kernels/fused_step.py:fused_step_batched_pallas
// (_fused_batched_kernel).  For x [B,m,n] and f32 centroids c [B,k,n] they
// return, for every stream b, kernel A16's (A3's) statistics of
// (x[b], c[b]): sums [B,k,n], counts [B,k], obj [B].
//
// Bound: bytes.  D16 reads x once at 2 bytes an element; at the batched main
// path's shapes (B = 8, m = 64,000, k = 25, n = 28) that is 28.7 MB, 8.6 us
// at 3.35 TB/s; D3 reads it at 4 bytes (57.3 MB, 17.1 us).
// Design: kernel D's — a 2-D grid (CTA, stream), every stream on kernel
// A16's (A3's) per-stream grid running its CTA body (common.cuh:fused_cta)
// on per-stream base pointers, the centroid norms of all streams from one
// first launch (common.cuh:sqnorm_rows, row by row), and a last launch that
// adds each stream's per-CTA partials in CTA order.  So stream b is
// bitwise equal to A16 (A3) on (x[b], c[b]), and repeated launches are
// bitwise equal.  No atomics.
#include "common.cuh"

using namespace repro;

template <class Ops>
__device__ __forceinline__ void batched_cta(
    TileSmemT<Ops>& s, const typename Ops::X* __restrict__ x,
    const float* __restrict__ c, const float* __restrict__ csq,
    float* __restrict__ part, int64_t m, int k, int n, int64_t num_tiles) {
  const int64_t stride = (int64_t)k * n + k + 1;
  const int64_t b = blockIdx.y;
  fused_cta(s, x + b * m * n, c + b * k * n,
            part + (b * gridDim.x + blockIdx.x) * stride, m, k, n, num_tiles,
            csq + b * k);
}

extern "C" __global__ void __launch_bounds__(TM, FUSED_MIN_CTAS)
fused_step_batched_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ c,
                               const float* __restrict__ csq,
                               float* __restrict__ part, int64_t m, int k,
                               int n, int64_t num_tiles) {
  __shared__ TileSmemT<Bf16Ops> s;
  batched_cta(s, x, c, csq, part, m, k, n, num_tiles);
}

extern "C" __global__ void __launch_bounds__(TM)
fused_step_batched_bf16x3_kernel(const float* __restrict__ x,
                                 const float* __restrict__ c,
                                 const float* __restrict__ csq,
                                 float* __restrict__ part, int64_t m, int k,
                                 int n, int64_t num_tiles) {
  __shared__ TileSmemT<Bf16x3Ops> s;
  batched_cta(s, x, c, csq, part, m, k, n, num_tiles);
}

extern "C" __global__ void fused_step_batched_16_reduce(
    const float* __restrict__ part, float* __restrict__ out, int64_t stride,
    int G) {
  const int64_t b = blockIdx.y;
  reduce_partials(part + b * G * stride, out + b * stride, stride, G);
}

// x [batch,m,n], c [batch,k,n] f32; csq: scratch [batch, k];
// part: scratch [batch, grid, k*n + k + 1]; out: [batch, k*n + k + 1], each
// row sums (row-major) ++ counts ++ obj.  `grid` CTAs per stream.
template <class X, class Kernel>
static int launch_batched_16(Kernel kernel, const X* x, const float* c,
                             float* csq, float* part, float* out, int batch,
                             int64_t m, int k, int n, int grid,
                             void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t stride = (int64_t)k * n + k + 1;
  const int64_t rows = (int64_t)batch * k;
  cudaStream_t st = (cudaStream_t)stream;
  sqnorm_rows<<<sqnorm_grid(rows, n), 256, 0, st>>>(c, csq, rows, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid, batch), TM, 0, st>>>(x, c, csq, part, m, k, n,
                                          num_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_batched_16_reduce<<<dim3(reduce_grid(stride), batch), 256, 0,
                                 st>>>(part, out, stride, grid);
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_step_batched_bf16(const __nv_bfloat16* x,
                                             const float* c, float* csq,
                                             float* part, float* out,
                                             int batch, int64_t m, int k,
                                             int n, int grid, void* stream) {
  return launch_batched_16(fused_step_batched_bf16_kernel, x, c, csq, part,
                           out, batch, m, k, n, grid, stream);
}

extern "C" int repro_fused_step_batched_bf16x3(const float* x, const float* c,
                                               float* csq, float* part,
                                               float* out, int batch,
                                               int64_t m, int k, int n,
                                               int grid, void* stream) {
  return launch_batched_16(fused_step_batched_bf16x3_kernel, x, c, csq, part,
                           out, batch, m, k, n, grid, stream);
}
