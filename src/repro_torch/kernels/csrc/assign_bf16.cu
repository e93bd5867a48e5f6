// Kernels B16 and B3: assign_bf16 / assign_bf16x3 — nearest-centroid
// assignment under the 'bf16' and 'bf16x3' precision policies.
//
// Replace the bf16 and bf16x3 bodies of the Pallas kernel
// repro/kernels/distance.py:assign_pallas (_assign_kernel).  For x [m,n]
// (bf16 for B16, f32 for B3) and f32 centroids c [k,n] they write
//   ids[i] = argmin_j (csq[j] - 2 dot(x_i, c_j))   (ties: lowest j)
//   d[i]   = max(min_j(...) + ||x_i||^2, 0)
// with csq = ||c_j||^2 from the f32 centroids (a first launch,
// common.cuh:sqnorm_rows), ||x||^2 from the stored values and the dot of
// the policy, as distance.py:184-190 has them: the norm of c is taken
// before the storage cast.
//
// B16 is a wgmma product with a fused argmin (assign_mma.cuh): c rounded
// to bf16 (nearest, ties to even) by a cast launch into scratch, products
// f32 += bf16 * bf16 on the tensor cores.  Bound: operations at the
// two-pass shape (2 s k n at 989 TFLOP/s), bytes at the main path's.
//
// B3 is kernel B's CTA body (common.cuh:assign_cta, one thread per point,
// centroids k-tiled in shared memory, a k tile's dots in registers) under
// common.cuh:Bf16x3Ops, on the CUDA cores.  Bound: bytes (x read once at
// 4 bytes an element, 8m bytes out).
#include "assign_mma.cuh"

using namespace repro;

// c [k, n] f32 -> cb [k, n] bf16, rounded to nearest, ties to even.
static __global__ void cast_bf16_rows(const float* __restrict__ c,
                                      __nv_bfloat16* __restrict__ cb,
                                      int64_t count) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (int64_t)gridDim.x * blockDim.x)
    cb[e] = __float2bfloat16_rn(c[e]);
}

extern "C" __global__ void __launch_bounds__(TM)
assign_bf16x3_kernel(const float* __restrict__ x,
                     const float* __restrict__ c,
                     const float* __restrict__ csq,
                     int32_t* __restrict__ ids, float* __restrict__ d,
                     int64_t m, int k, int n, int64_t num_tiles) {
  __shared__ TileSmemT<Bf16x3Ops> s;
  assign_cta(s, x, c, ids, d, m, k, n, num_tiles, csq);
}

// Kernel B16.  csq: scratch [k]; cb: scratch [k, n] bf16; sbest, sidx:
// scratch [ceil(k / bn), m]; bn: centroids per output tile (64 or 128);
// grid: persistent CTAs.
extern "C" int repro_assign_bf16(const __nv_bfloat16* x, const float* c,
                                 float* csq, __nv_bfloat16* cb, float* sbest,
                                 int32_t* sidx, int32_t* ids, float* d,
                                 int64_t m, int k, int n, int bn, int grid,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  REPRO_LAUNCH(sqnorm_rows, sqnorm_grid(k, n), 256, 0, st, c, csq, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t count = (int64_t)k * n;
  const int64_t blocks = (count + 255) / 256;
  REPRO_LAUNCH(cast_bf16_rows, (unsigned)(blocks < 1024 ? blocks : 1024),
               256, 0, st, c, cb, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_assign_mma<__nv_bfloat16, float, false>(
      x, cb, csq, nullptr, nullptr, sbest, sidx, ids, d, m, k, n, bn, grid,
      st);
}

// Kernel B3.  csq: scratch [k]; ids, d: [m].
extern "C" int repro_assign_bf16x3(const float* x, const float* c,
                                   float* csq, int32_t* ids, float* d,
                                   int64_t m, int k, int n, int grid,
                                   void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  sqnorm_rows<<<sqnorm_grid(k, n), 256, 0, st>>>(c, csq, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    assign_bf16x3_kernel<<<grid, TM, 0, st>>>(x, c, csq, ids, d, m, k, n,
                                              num_tiles);
  }
  return (int)cudaGetLastError();
}
