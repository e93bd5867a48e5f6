// Kernels C16 and C3: update_bf16 / update_bf16x3 — per-cluster sums and
// counts under the 'bf16' and 'bf16x3' precision policies.
//
// Replace the bf16 and bf16x3 bodies of the Pallas kernel
// repro/kernels/update.py:update_pallas (_update_kernel), whose one-hot
// contraction runs through px.dot at the policy.  For x [m,n] (bf16 for
// C16, f32 for C3) and ids [m] int32 they compute
//   C16: sums[j, f] = sum_{i : ids_i == j} x[i, f] (bf16 values, f32 sums);
//   C3:  sums[j, f] = sum x_hi[i, f] + sum x_lo[i, f] per point tile, with
//        x_hi = bf16(x), x_lo = bf16(x - x_hi): the one-hot is exact in
//        bf16, so its low part adds nothing (update.py, precision.py:dot);
//   counts[j] = #{i : ids_i == j},
// where an id outside [0, k) adds nothing.
//
// Bound: bytes.  C16 reads x at 2 bytes an element and ids at 4 (2mn + 4m
// bytes), C3 reads x at 4.  Design: kernel C's (common.cuh:update_cta,
// tile_accumulate): each thread owns fixed (cluster, feature) elements of
// its CTA's partials and adds the tile's rows in order; a second launch
// reduces the per-CTA partials in CTA order.  No atomics.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
update_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const int32_t* __restrict__ ids, float* __restrict__ part,
                   int64_t m, int k, int n, int64_t num_tiles) {
  __shared__ TileSmemT<Bf16Ops> s;
  const int64_t stride = (int64_t)k * n + k;
  update_cta(s, x, ids, part + blockIdx.x * stride, m, k, n, num_tiles);
}

extern "C" __global__ void __launch_bounds__(TM)
update_bf16x3_kernel(const float* __restrict__ x,
                     const int32_t* __restrict__ ids, float* __restrict__ part,
                     int64_t m, int k, int n, int64_t num_tiles) {
  __shared__ TileSmemT<Bf16x3Ops> s;
  const int64_t stride = (int64_t)k * n + k;
  update_cta(s, x, ids, part + blockIdx.x * stride, m, k, n, num_tiles);
}

extern "C" __global__ void update_16_reduce(const float* __restrict__ part,
                                            float* __restrict__ out,
                                            int64_t stride, int G) {
  reduce_partials(part, out, stride, G);
}

// part: scratch [grid, k*n + k]; out: [k*n + k] = sums (row-major) ++ counts.
template <class X, class Kernel>
static int launch_update_16(Kernel kernel, const X* x, const int32_t* ids,
                            float* part, float* out, int64_t m, int k, int n,
                            int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t stride = (int64_t)k * n + k;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<grid, TM, 0, st>>>(x, ids, part, m, k, n, num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_16_reduce<<<reduce_grid(stride), 256, 0, st>>>(part, out, stride,
                                                        grid);
  return (int)cudaGetLastError();
}

extern "C" int repro_update_bf16(const __nv_bfloat16* x, const int32_t* ids,
                                 float* part, float* out, int64_t m, int k,
                                 int n, int grid, void* stream) {
  return launch_update_16(update_bf16_kernel, x, ids, part, out, m, k, n,
                          grid, stream);
}

extern "C" int repro_update_bf16x3(const float* x, const int32_t* ids,
                                   float* part, float* out, int64_t m, int k,
                                   int n, int grid, void* stream) {
  return launch_update_16(update_bf16x3_kernel, x, ids, part, out, m, k, n,
                          grid, stream);
}
