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
// the policy (common.cuh:Bf16Ops, Bf16x3Ops), as distance.py:184-190 has
// them: the norm of c is taken before the storage cast.
//
// Bound: bytes.  B16 reads x once at 2 bytes an element and writes 8m bytes;
// B3 reads it at 4.  Design: kernel B's (common.cuh:assign_cta, one thread
// per point, centroids k-tiled in shared memory, a k tile's dots in
// registers) under the policy.  CUDA cores only, no tensor cores yet.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
assign_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ c, const float* __restrict__ csq,
                   int32_t* __restrict__ ids, float* __restrict__ d,
                   int64_t m, int k, int n, int64_t num_tiles) {
  __shared__ TileSmemT<Bf16Ops> s;
  assign_cta(s, x, c, ids, d, m, k, n, num_tiles, csq);
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

// csq: scratch [k]; ids, d: [m].
template <class X, class Kernel>
static int launch_assign_16(Kernel kernel, const X* x, const float* c,
                            float* csq, int32_t* ids, float* d, int64_t m,
                            int k, int n, int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  sqnorm_rows<<<sqnorm_grid(k), 256, 0, st>>>(c, csq, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (num_tiles > 0) {
    kernel<<<grid, TM, 0, st>>>(x, c, csq, ids, d, m, k, n, num_tiles);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_assign_bf16(const __nv_bfloat16* x, const float* c,
                                 float* csq, int32_t* ids, float* d,
                                 int64_t m, int k, int n, int grid,
                                 void* stream) {
  return launch_assign_16(assign_bf16_kernel, x, c, csq, ids, d, m, k, n,
                          grid, stream);
}

extern "C" int repro_assign_bf16x3(const float* x, const float* c,
                                   float* csq, int32_t* ids, float* d,
                                   int64_t m, int k, int n, int grid,
                                   void* stream) {
  return launch_assign_16(assign_bf16x3_kernel, x, c, csq, ids, d, m, k, n,
                          grid, stream);
}
