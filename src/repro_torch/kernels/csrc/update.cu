// Kernel C: update_f32 — per-cluster sums and counts in fp32.
//
// Replaces the Pallas kernel repro/kernels/update.py:update_pallas
// (_update_kernel).  For x [m,n] fp32 and ids [m] int32 it computes
//   sums[j, f] = sum_{i : ids_i == j} x[i, f],   counts[j] = #{i : ids_i == j}
// where an id outside [0, k) adds nothing.
//
// Bound: bytes.  It reads x and ids once (4mn + 4m bytes) and writes
// 4(kn + k).  Design: the sorted scatter of update.cuh — a tile pass that
// sorts each 256-row tile by cluster and sums each cluster's run of rows,
// then a reduce that folds each cluster's tile sums in the association of
// the one-hot kernel it replaced, so the result is bitwise that kernel's.
// No atomics.
#include "update.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
update_f32_tiles(const float* __restrict__ x, const int32_t* __restrict__ ids,
                 float* __restrict__ rec, float* __restrict__ rcnt,
                 int32_t* __restrict__ idx, int64_t m, int k, int n, int G) {
  __shared__ ScatterSmem<float> s;
  scatter_tile<SumF32>(s, x, ids, rec, rcnt, idx, m, k, n, G);
}

extern "C" __global__ void update_f32_reduce(
    int room, const float* __restrict__ rec, const float* __restrict__ rcnt,
    const int32_t* __restrict__ idx, float* __restrict__ out, int k, int n,
    int64_t tiles, int G) {
  __shared__ ReduceSmem rs;
  scatter_reduce(rs, reinterpret_cast<float*>(dynamic_smem()), room, rec,
                 rcnt, idx, out, out + (int64_t)k * n, k, n, tiles, G);
}

// rec: scratch [tiles * min(256, k), record_stride(n)]; rcnt: [tiles * min(256, k)];
// idx: [k, tiles]; out: [k*n + k] = sums (row-major) ++ counts.  G: the
// reduce's association (update.cuh).
extern "C" int repro_update_f32(const float* x, const int32_t* ids,
                                float* rec, float* rcnt, int32_t* idx,
                                float* out, int64_t m, int k, int n, int G,
                                void* stream) {
  const int64_t tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles > 0) {
    const unsigned blocks = tile_blocks<float>(n);
    update_f32_tiles<<<dim3((unsigned)tiles, blocks), TM, 0, st>>>(
        x, ids, rec, rcnt, idx, m, k, n, G);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int room = reduce_buffer(tiles, n, m, k);
  update_f32_reduce<<<dim3(k, reduce_blocks(n)), RT, 4 * room, st>>>(
      room, rec, rcnt, idx, out, k, n, tiles, G);
  return (int)cudaGetLastError();
}
