// Kernel B8: assign_int8 — nearest-centroid assignment of an int8-quantized
// chunk, a wgmma product with a fused argmin (assign_mma.cuh).
//
// Replaces the Pallas kernel repro/kernels/distance.py:_assign_pallas_q
// (_assign_kernel_q, distance.py:96-148).  For the codes xq [m,n] with
// per-feature scales scale [n], and the centroids' codes cq [k,n], row
// scales t [k] and full-width centroids cf [k,n] f32 (norms csq [k] from a
// first launch, sqnorm_rows), it writes
//   ids[i] = argmin_j (csq[j] - 2 float(xq_i . cq_j) t[j])   (ties: lowest j)
//   d[i]   = max(min_j(...) + ||deq(x_i)||^2, 0)
// with the integer dot exact in int32 (s32 += s8 * s8 on the tensor
// cores), so ids and d are bitwise those of the CUDA-core kernel it
// replaced (common.cuh:tile_argmin_q).
//
// Bound: operations at the two-pass shape (2 s k n int8 operations at
// 1,979 TOP/s), bytes at the main path's (the codes once, 8m bytes out).
#include "assign_mma.cuh"

using namespace repro;

// cf: [k, n] f32 centroids; csq: scratch [k]; sbest, sidx: scratch
// [ceil(k / bn), m]; bn: centroids per output tile (64 or 128); grid:
// persistent CTAs.
extern "C" int repro_assign_int8(const int8_t* x, const int8_t* c,
                                 const float* cf, float* csq, const float* t,
                                 const float* scale, float* sbest,
                                 int32_t* sidx, int32_t* ids, float* d,
                                 int64_t m, int k, int n, int bn, int grid,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  REPRO_LAUNCH(sqnorm_rows, sqnorm_grid(k, n), 256, 0, st, cf, csq, k, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_assign_mma<int8_t, int, true>(x, c, csq, t, scale, sbest,
                                              sidx, ids, d, m, k, n, bn,
                                              grid, st);
}

// Dynamic shared memory of the tensor-core pass of B8 (which = 0), B16 (1)
// or B3 (2) with bn centroids a tile.
extern "C" int repro_assign_mma_smem_bytes(int which, int bn) {
  if (bn == 64)
    return which == 0   ? mma_smem_bytes<int, 64>()
           : which == 1 ? mma_smem_bytes<float, 64>()
                        : mma_smem_bytes<float, 64, 2>();
  return which == 0   ? mma_smem_bytes<int, 128>()
         : which == 1 ? mma_smem_bytes<float, 128>()
                      : mma_smem_bytes<float, 128, 2>();
}
