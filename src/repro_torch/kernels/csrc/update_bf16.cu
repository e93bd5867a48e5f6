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
// bytes), C3 reads x at 4.  Design: kernel C's sorted scatter (update.cuh)
// with the policy's sum (SumBf16, SumBf16x3), bitwise the one-hot kernels
// it replaced.  No atomics.
#include "update.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
update_bf16_tiles(const __nv_bfloat16* __restrict__ x,
                  const int32_t* __restrict__ ids, float* __restrict__ rec,
                  float* __restrict__ rcnt, int32_t* __restrict__ idx,
                  int64_t m, int k, int n, int G) {
  __shared__ ScatterSmem<__nv_bfloat16> s;
  scatter_tile<SumBf16>(s, x, ids, rec, rcnt, idx, m, k, n, G);
}

extern "C" __global__ void __launch_bounds__(TM)
update_bf16x3_tiles(const float* __restrict__ x,
                    const int32_t* __restrict__ ids, float* __restrict__ rec,
                    float* __restrict__ rcnt, int32_t* __restrict__ idx,
                    int64_t m, int k, int n, int G) {
  __shared__ ScatterSmem<float> s;
  scatter_tile<SumBf16x3>(s, x, ids, rec, rcnt, idx, m, k, n, G);
}

extern "C" __global__ void update_16_reduce(
    int room, const float* __restrict__ rec, const float* __restrict__ rcnt,
    const int32_t* __restrict__ idx, float* __restrict__ out, int k, int n,
    int64_t tiles, int G) {
  __shared__ ReduceSmem rs;
  scatter_reduce(rs, reinterpret_cast<float*>(dynamic_smem()), room, rec,
                 rcnt, idx, out, out + (int64_t)k * n, k, n, tiles, G);
}

// rec: scratch [tiles * min(256, k), record_stride(n)]; rcnt: [tiles * min(256, k)];
// idx: [k, tiles]; out: [k*n + k] = sums (row-major) ++ counts.
template <class X, class Kernel>
static int launch_update_16(Kernel kernel, const X* x, const int32_t* ids,
                            float* rec, float* rcnt, int32_t* idx,
                            float* out, int64_t m, int k, int n, int G,
                            void* stream) {
  const int64_t tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles > 0) {
    const unsigned blocks = tile_blocks<X>(n);
    kernel<<<dim3((unsigned)tiles, blocks), TM, 0, st>>>(
        x, ids, rec, rcnt, idx, m, k, n, G);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int room = reduce_buffer(tiles, n, m, k);
  update_16_reduce<<<dim3(k, reduce_blocks(n)), RT, 4 * room, st>>>(
      room, rec, rcnt, idx, out, k, n, tiles, G);
  return (int)cudaGetLastError();
}

extern "C" int repro_update_bf16(const __nv_bfloat16* x, const int32_t* ids,
                                 float* rec, float* rcnt, int32_t* idx,
                                 float* out, int64_t m, int k, int n, int G,
                                 void* stream) {
  return launch_update_16(update_bf16_tiles, x, ids, rec, rcnt, idx, out, m,
                          k, n, G, stream);
}

extern "C" int repro_update_bf16x3(const float* x, const int32_t* ids,
                                   float* rec, float* rcnt, int32_t* idx,
                                   float* out, int64_t m, int k, int n, int G,
                                   void* stream) {
  return launch_update_16(update_bf16x3_tiles, x, ids, rec, rcnt, idx, out,
                          m, k, n, G, stream);
}
