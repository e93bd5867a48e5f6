// Kernel B8: assign_int8 — nearest-centroid assignment of an int8-quantized
// chunk.
//
// Replaces the Pallas kernel repro/kernels/distance.py:_assign_pallas_q
// (_assign_kernel_q, distance.py:96-148).  For the codes xq [m,n] with
// per-feature scales scale [n], and the centroids' codes cq [k,n], row
// scales t [k] and full-width centroids cf [k,n] f32 (norms csq [k] from a
// first launch, sqnorm_rows), it writes
//   ids[i] = argmin_j (csq[j] - 2 float(xq_i . cq_j) t[j])   (ties: lowest j)
//   d[i]   = max(min_j(...) + ||deq(x_i)||^2, 0)
// with the integer dot exact in int32 (common.cuh:tile_argmin_q).
//
// Bound: bytes.  It reads the codes once (mn bytes) and writes 8m bytes; at
// the main path's shapes (m = 64,000, k = 25, n = 28) that is 2.3 MB.
// Design: kernel B's, on the int8 tile (common.cuh:TileSmemQ): one thread
// per point, codes staged through shared memory with coalesced byte loads,
// centroid codes k-tiled in shared memory and the KT int32 dots of a k tile
// in registers.  No dp4a, no tensor cores yet.
#include "common.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(TM)
assign_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ c,
                   const float* __restrict__ csq,
                   const float* __restrict__ tq,
                   const float* __restrict__ scale, int32_t* __restrict__ ids,
                   float* __restrict__ d, int64_t m, int k, int n,
                   int64_t num_tiles) {
  __shared__ TileSmemQ s;
  SyncLoad xin;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin_q(s, x, c, csq, tq, scale, m, k, n, r0, bidx, best, xsq,
                  xin);
    const int64_t r = r0 + threadIdx.x;
    if (r < m) {
      ids[r] = bidx;
      d[r] = fmaxf(best + xsq, 0.f);
    }
  }
}

// cf: [k, n] f32 centroids; csq: scratch [k].
extern "C" int repro_assign_int8(const int8_t* x, const int8_t* c,
                                 const float* cf, float* csq, const float* t,
                                 const float* scale, int32_t* ids, float* d,
                                 int64_t m, int k, int n, int grid,
                                 void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  if (num_tiles > 0) {
    sqnorm_rows<<<sqnorm_grid(k), 256, 0, st>>>(cf, csq, k, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    assign_int8_kernel<<<grid, TM, 0, st>>>(x, c, csq, t, scale, ids, d, m,
                                            k, n, num_tiles);
  }
  return (int)cudaGetLastError();
}
