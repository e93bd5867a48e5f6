// Kernel B: assign_f32 — nearest-centroid assignment in true fp32.
//
// Replaces the Pallas kernel repro/kernels/distance.py:assign_pallas
// (_assign_kernel).  For x [m,n] and c [k,n] (row-major fp32) it writes
//   ids[i] = argmin_j (||c_j||^2 - 2 x_i.c_j)   (ties: lowest j)
//   d[i]   = max(min_j(...) + ||x_i||^2, 0)
// with the score, the tie rule and the 1e30 initial best of
// distance.py:65,83-93.
//
// Bound: bytes at the main path's shapes (m = 64,000 or 262,144-row evaluate
// batches, k = 25, n = 28: ~0.3 flop per byte), fp32 operations at the
// two-pass route's (s = 16,384, k = 2,048, n = 1,024: 2 s k n = 68.7 G
// flops at 67 TFLOP/s).
//
// Design: a register-tiled product x . c^T on the CUDA cores with a fused
// argmin.  'f32' means true fp32, so no tensor cores (no TF32, no split):
// fmaf only.
//  * A CTA of F32_THREADS = 256 threads computes output tiles of
//    F32_BM = 128 rows by BN = 32 (k <= 32) or 128 centroids, persistent
//    over the tiles blockIdx.x, blockIdx.x + gridDim.x, ... (centroid tile
//    fastest).  Every output tile is one CTA's, so results do not depend on
//    the grid.  Thread (ty, tx) holds a microtile of 8 x 8 (BN = 128) or
//    4 x 4 (BN = 32) in registers, rows and centroids in groups of four
//    (F32Tile): one 16-byte shared-memory load per four rows or centroids
//    and feature, two or four a feature for 64 or 16 FMAs.
//  * Operands reach shared memory in slabs of F32_BK = 16 features, stored
//    feature-major (transposed; rows padded by 4 floats), in a ring of
//    slabs filled by 4-byte cp.async ahead of the product (a
//    transposing copy takes one element at a time).  The copy and compute
//    cursors step through the CTA's tiles without divisions.
//    Features past n and rows past m or k are zeros: fmaf(0, 0, acc) = acc.
//  * Arithmetic bitwise kernel B's CUDA-core body before it
//    (common.cuh:assign_cta under F32Ops): each dot one fmaf chain from 0
//    in feature order; ||c||^2 the same chain over c (a first launch,
//    sqnorm_chain_rows), ||x||^2 over x (taken in the pass by the CTAs of
//    centroid tile 0); score = c2 - 2 dot; the running (min, index) from
//    (BIG, 0) with a strict '<'.
//  * Epilogue, fused: each thread scans its columns in increasing order
//    (j >= k masked by index, never by value), the 16 or 8 lanes that
//    share a row fold with shuffles (lowest index among equal minima).  With one
//    centroid tile the pass writes ids and d; with more, one (best, idx) a
//    row and tile goes to scratch and assign_fold_f32 folds the tiles in
//    order, as B8's and B16's fold does.
//  * No atomics and no fallback: a launch that fails returns its error.
#include "assign_mma.cuh"

using namespace repro;

namespace {

constexpr int F32_BM = 128;      // rows per output tile
constexpr int F32_BK = 16;       // features per slab
constexpr int F32_THREADS = 256;
constexpr int F32_XS = F32_BM + 4;  // floats per feature row of the x slab

// A tile of F32_BM rows by BN centroids: TY x TX threads, each with tr
// rows (groups of four, 4 TY apart) by tc centroids (groups of four,
// 4 TX apart).  BN = 128: 16 x 16 threads of 8 x 8; BN = 32: 32 x 8
// threads of 4 x 4.  A ring of `stages` slabs, stages - 1 copied ahead: a
// slab of BN = 32 is a fifth of the work of one of 128, so its ring is
// deeper to cover the same latency.
template <int BN>
struct F32Tile {
  static constexpr int tx = BN == 32 ? 8 : 16;  // threads along centroids
  static constexpr int ty = F32_THREADS / tx;   // ... and along rows
  static constexpr int tr = F32_BM / ty;        // rows per thread
  static constexpr int tc = BN / tx;            // centroids per thread
  static constexpr int cs = BN + 4;             // floats per feature row
  static constexpr int stages = BN == 32 ? 6 : 3;
  static constexpr int slot = F32_BK * (F32_XS + cs);  // floats a slot
  static constexpr int smem_bytes = stages * slot * 4;
  static_assert(tr % 4 == 0 && tc % 4 == 0, "groups of four");
  // the thread's row ii and centroid jj of the tile (increasing in each)
  __device__ static int row(int y, int ii) {
    return (ii / 4) * (4 * ty) + y * 4 + ii % 4;
  }
  __device__ static int col(int x, int jj) {
    return (jj / 4) * (4 * tx) + x * 4 + jj % 4;
  }
};

__device__ __forceinline__ void lds4(float* out, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Stage features [f0, f0 + F32_BK) of rows [row0, row0 + ROWS) of g (rows
// of n floats, `total` rows) feature-major into dst (stride floats a
// feature): thread t copies feature t % 16 of rows t / 16 + 16 i, so a warp
// reads two 64-byte row segments.  Out of range: zeros, stored at once.
template <int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, int stride,
                                          const float* __restrict__ g,
                                          int64_t total, int n, int64_t row0,
                                          int f0) {
  constexpr int step = F32_THREADS / F32_BK;     // rows a pass
  static_assert(ROWS % step == 0, "whole passes");
  const int f = threadIdx.x % F32_BK;
  const int r = threadIdx.x / F32_BK;
  const bool in_row = f0 + f < n;
  const int64_t left = total - row0 - r;         // rows of g from this one
  const float* src = g + (in_row && left > 0 ? (row0 + r) * n + f0 + f : 0);
  float* p = dst + f * stride + r;
#pragma unroll
  for (int i = 0; i < ROWS / step; ++i) {
    if (in_row && step * i < left)
      cp_async4(p + step * i, src + (int64_t)step * i * n);
    else
      p[step * i] = 0.f;
  }
}

// The pass: for each output tile of this CTA, the product over all slabs of
// n, then the fused argmin.  csq: the centroid norms (sqnorm_chain_rows).
// With one centroid tile it writes ids and d; else sbest, sidx [ntiles, m]
// and (tile 0's CTAs) xsq [m].
template <int BN>
__global__ void __launch_bounds__(F32_THREADS, 2)
    assign_f32_pass(const float* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ csq, float* __restrict__ sbest,
                    int32_t* __restrict__ sidx, float* __restrict__ xsq_out,
                    int32_t* __restrict__ ids, float* __restrict__ d,
                    int64_t m, int k, int n, int ntiles) {
  using T = F32Tile<BN>;
  constexpr int TR = T::tr, TC = T::tc;
  float* smem = reinterpret_cast<float*>(dynamic_smem());
  const int tx = threadIdx.x % T::tx;
  const int ty = threadIdx.x / T::tx;
  const int ks = (n + F32_BK - 1) / F32_BK;  // slabs per tile
  const int64_t tiles = (m + F32_BM - 1) / F32_BM * ntiles;
  // The copy cursor: the next slab to stage (slab sk of tile st, into ring
  // slot ss); tiles blockIdx.x, blockIdx.x + gridDim.x, ... in order.
  int64_t st = blockIdx.x, srow = st / ntiles * F32_BM;
  int sk = 0, ss = 0, scol = (int)(st % ntiles) * BN;
  auto stage = [&]() {
    if (st < tiles) {
      float* a = smem + ss * T::slot;
      stage_f32<F32_BM>(a, F32_XS, x, m, n, srow, sk * F32_BK);
      stage_f32<BN>(a + F32_BK * F32_XS, T::cs, c, k, n, scol, sk * F32_BK);
      ss = ss + 1 == T::stages ? 0 : ss + 1;
      if (++sk == ks) {
        sk = 0;
        st += gridDim.x;
        srow = st / ntiles * F32_BM;
        scol = (int)(st % ntiles) * BN;
      }
    }
    cp_async_commit();
  };
  constexpr int ahead = T::stages - 1;
  float acc[TR][TC];
  float xq[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    xq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  }
  for (int s = 0; s < ahead; ++s) stage();
  // The compute cursor: slab kk of tile `tile`, in ring slot `slot`.
  int64_t tile = blockIdx.x;
  int kk = 0, slot = 0, nt = (int)(tile % ntiles);
  while (tile < tiles) {
    cp_async_wait<ahead - 1>();  // this thread's copies of this slab ...
    __syncthreads();  // ... everyone's; the slot of the slab before is free
    stage();          // into the slot of the slab before
    const float* xs = smem + slot * T::slot;
    const float* cs = xs + F32_BK * F32_XS;
    slot = slot + 1 == T::stages ? 0 : slot + 1;
    const bool norms = nt == 0;  // ||x||^2 taken by centroid tile 0
#pragma unroll
    for (int f = 0; f < F32_BK; ++f) {
      float a[TR], b[TC];
#pragma unroll
      for (int q = 0; q < TR / 4; ++q)
        lds4(a + 4 * q, xs + f * F32_XS + q * 4 * T::ty + ty * 4);
#pragma unroll
      for (int q = 0; q < TC / 4; ++q)
        lds4(b + 4 * q, cs + f * T::cs + q * 4 * T::tx + tx * 4);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (norms) {
#pragma unroll
        for (int i = 0; i < TR; ++i) xq[i] = fmaf(a[i], a[i], xq[i]);
      }
    }
    if (++kk < ks) continue;
    // the tile's epilogue: scores, the thread's scan, the lanes' fold
    const int64_t row0 = tile / ntiles * F32_BM;
    float c2[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = nt * BN + T::col(tx, j);
      c2[j] = col < k ? csq[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float best = BIG;
      int idx = 0;
#pragma unroll
      for (int j = 0; j < TC; ++j) {  // columns in increasing order
        const int col = nt * BN + T::col(tx, j);
        if (col < k) {
          const float score = c2[j] - 2.f * acc[i][j];
          if (score < best) {
            best = score;
            idx = col;
          }
        }
        acc[i][j] = 0.f;
      }
#pragma unroll
      for (int mask = 1; mask < T::tx; mask <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, mask);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, mask);
        take_lower(best, idx, ob, oi);
      }
      const int64_t r = row0 + T::row(ty, i);
      if (tx == 0 && r < m) {
        if (ntiles == 1) {
          ids[r] = idx;
          d[r] = fmaxf(best + xq[i], 0.f);
        } else {
          sbest[(int64_t)nt * m + r] = best;
          sidx[(int64_t)nt * m + r] = idx;
          if (nt == 0) xsq_out[r] = xq[i];
        }
      }
      xq[i] = 0.f;
    }
    kk = 0;
    tile += gridDim.x;
    nt = (int)(tile % ntiles);
  }
  cp_async_wait<0>();
}

template <int BN>
int launch_f32(const float* x, const float* c, const float* csq,
               float* sbest, int32_t* sidx, float* xsq, int32_t* ids,
               float* d, int64_t m, int k, int n, int grid,
               cudaStream_t st) {
  const int ntiles = (k + BN - 1) / BN;
  auto pass = assign_f32_pass<BN>;
  constexpr int smem = F32Tile<BN>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  REPRO_LAUNCH(pass, grid, F32_THREADS, smem, st, x, c, csq, sbest, sidx,
               xsq, ids, d, m, k, n, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 1) return (int)err;
  REPRO_LAUNCH(assign_fold_f32, fold_grid(m), 256, 0, st, xsq, sbest, sidx,
               ids, d, m, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// csq: scratch [k]; sbest, sidx: scratch [ceil(k / bn), m] and xsq: scratch
// [m] (used when k > bn); bn: centroids per output tile (32 or 128); grid:
// persistent CTAs.
extern "C" int repro_assign_f32(const float* x, const float* c, float* csq,
                                float* sbest, int32_t* sidx, float* xsq,
                                int32_t* ids, float* d, int64_t m, int k,
                                int n, int bn, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 0) return (int)cudaSuccess;
  REPRO_LAUNCH(sqnorm_chain_rows, chain_grid(k, n), 256, 0, st, c, csq, k,
               n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bn == 32)
    return launch_f32<32>(x, c, csq, sbest, sidx, xsq, ids, d, m, k, n, grid,
                          st);
  if (bn == 128)
    return launch_f32<128>(x, c, csq, sbest, sidx, xsq, ids, d, m, k, n,
                           grid, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
