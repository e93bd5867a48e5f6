// Kernel C8: update_int8 — per-cluster sums of an int8-quantized chunk.
//
// Replaces the Pallas kernel repro/kernels/update.py:_update_pallas_q
// (_update_kernel_q, update.py:67-97).  For the codes xq [m,n] and ids [m]
// int32 it computes
//   isums[j, f] = sum_{i : ids_i == j} xq[i, f]   (exact int32)
//   counts[j]   = #{i : ids_i == j}              (f32)
// where an id outside [0, k) adds nothing (padding rows carry -1).  The
// wrapper scales isums by the chunk's per-feature scales after the reduce
// (update.py:205-207).
//
// Bound: bytes.  It reads the codes and ids once (mn + 4m bytes) and
// writes 4(kn + k).  Design: kernel C's sorted scatter (update.cuh) on the
// codes, with exact int32 sums (SumInt8).  No atomics.
#include "update.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
update_int8_tiles(const int8_t* __restrict__ x,
                  const int32_t* __restrict__ ids, int32_t* __restrict__ rec,
                  float* __restrict__ rcnt, int32_t* __restrict__ idx,
                  int64_t m, int k, int n, int G) {
  __shared__ ScatterSmem<int8_t> s;
  scatter_tile<SumInt8>(s, x, ids, rec, rcnt, idx, m, k, n, G);
}

extern "C" __global__ void update_int8_reduce(
    int room, const int32_t* __restrict__ rec, const float* __restrict__ rcnt,
    const int32_t* __restrict__ idx, int32_t* __restrict__ osum,
    float* __restrict__ ocnt, int k, int n, int64_t tiles, int G) {
  __shared__ ReduceSmem rs;
  scatter_reduce(rs, reinterpret_cast<int32_t*>(dynamic_smem()), room, rec,
                 rcnt, idx, osum, ocnt, k, n, tiles, G);
}

// rec: scratch [tiles * min(256, k), record_stride(n)] int32; rcnt: [tiles * min(256, k)]
// f32; idx: [k, tiles] int32; osum: [k*n] int32 sums (row-major); ocnt:
// [k] counts.
extern "C" int repro_update_int8(const int8_t* x, const int32_t* ids,
                                 int32_t* rec, float* rcnt, int32_t* idx,
                                 int32_t* osum, float* ocnt, int64_t m, int k,
                                 int n, int G, void* stream) {
  const int64_t tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles > 0) {
    const unsigned blocks = tile_blocks<int8_t>(n);
    update_int8_tiles<<<dim3((unsigned)tiles, blocks), TM, 0, st>>>(
        x, ids, rec, rcnt, idx, m, k, n, G);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int room = reduce_buffer(tiles, n, m, k);
  update_int8_reduce<<<dim3(k, reduce_blocks(n)), RT, 4 * room, st>>>(
      room, rec, rcnt, idx, osum, ocnt, k, n, tiles, G);
  return (int)cudaGetLastError();
}
