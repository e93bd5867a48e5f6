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
// writes 4(kn + k); at the main path's shapes (m = 64,000, k = 25, n = 28)
// that is 2.05 MB.  Design: kernel C's one-hot contraction on the int8 tile
// (common.cuh:tile_accumulate_q): each CTA walks a fixed set of point tiles,
// each thread owns fixed (cluster, feature) elements of the CTA's int32
// partial sums; a second launch reduces the partials in CTA order.  No
// atomics.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
update_int8_kernel(const int8_t* __restrict__ x,
                   const int32_t* __restrict__ ids,
                   int32_t* __restrict__ psum, float* __restrict__ pcnt,
                   int64_t m, int k, int n, int64_t num_tiles) {
  __shared__ TileSmemQ s;
  const int64_t kn = (int64_t)k * n;
  int32_t* P = psum + blockIdx.x * kn;
  float* Cnt = pcnt + blockIdx.x * (int64_t)k;
  if (blockIdx.x >= num_tiles) {
    zero_partials(P, kn);
    zero_partials(Cnt, (int64_t)k);
    return;
  }
  SyncLoad xin;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    const int64_t r = r0 + threadIdx.x;
    int id = r < m ? ids[r] : -1;
    s.ids[threadIdx.x] = (id >= 0 && id < k) ? id : -1;
    __syncthreads();
    tile_accumulate_q(s, x, m, k, n, r0, P, Cnt, tile == blockIdx.x, false,
                      xin);
    __syncthreads();  // s.ids / s.xs are rewritten by the next tile
  }
}

extern "C" __global__ void update_int8_reduce(
    const int32_t* __restrict__ psum, const float* __restrict__ pcnt,
    int32_t* __restrict__ osum, float* __restrict__ ocnt, int64_t kn, int k,
    int G) {
  reduce_partials(psum, osum, kn, G);
  reduce_partials(pcnt, ocnt, (int64_t)k, G);
}

// psum: scratch [grid, k*n] int32; pcnt: scratch [grid, k] f32;
// osum: [k*n] int32 sums (row-major); ocnt: [k] counts.
extern "C" int repro_update_int8(const int8_t* x, const int32_t* ids,
                                 int32_t* psum, float* pcnt, int32_t* osum,
                                 float* ocnt, int64_t m, int k, int n,
                                 int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t kn = (int64_t)k * n;
  cudaStream_t st = (cudaStream_t)stream;
  update_int8_kernel<<<grid, TM, 0, st>>>(x, ids, psum, pcnt, m, k, n,
                                          num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_int8_reduce<<<reduce_grid(kn + k), 256, 0, st>>>(psum, pcnt, osum,
                                                          ocnt, kn, k, grid);
  return (int)cudaGetLastError();
}
