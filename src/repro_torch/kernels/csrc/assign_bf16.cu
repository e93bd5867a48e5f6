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
// B3 is the same wgmma product on the bf16 hi and lo parts of x and c
// (split by a launch into scratch, common.cuh:split_bf16, rows padded with
// zeros to 16 bytes): each slab's three products x_hi c_lo + x_lo c_hi +
// x_hi c_hi on the tensor cores, the reference's three bf16 products
// (precision.py:dot), summed in an order of their own (assign_mma.cuh).
// ||x||^2 is one fmaf chain over the f32 row (sqnorm_chain_rows).  Bound:
// operations at the two-pass shape (3 x 2 s k n at 989 TFLOP/s), bytes at
// the main path's (x read once at 4 bytes an element, 8m bytes out).
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

// The bf16 hi and lo parts of c [k, n] and x [m, n] (f32), one launch: row
// r < k of c, else row r - k of x, into hi, lo [*, ld] bf16 with
// hi = bf16(v), lo = bf16(v - hi), each rounded to nearest, ties to even
// (common.cuh:split_bf16), and zeros in columns n .. ld - 1.  A warp a row
// (rows warp, warp + 8 gridDim.x, ...), its lanes along the columns.
static __global__ void split_bf16_rows(const float* __restrict__ c,
                                       const float* __restrict__ x,
                                       __nv_bfloat16* __restrict__ ch,
                                       __nv_bfloat16* __restrict__ cl,
                                       __nv_bfloat16* __restrict__ xh,
                                       __nv_bfloat16* __restrict__ xl, int k,
                                       int64_t m, int n, int ld) {
  for (int64_t r = (int64_t)blockIdx.x * 8 + threadIdx.x / 32; r < k + m;
       r += (int64_t)gridDim.x * 8) {
    const bool is_c = r < k;
    const int64_t row = is_c ? r : r - k;
    const float* v = (is_c ? c : x) + row * n;
    __nv_bfloat16* hi = (is_c ? ch : xh) + row * ld;
    __nv_bfloat16* lo = (is_c ? cl : xl) + row * ld;
    for (int f = threadIdx.x % 32; f < ld; f += 32) {
      const float e = f < n ? v[f] : 0.f;
      const __nv_bfloat16 h = __float2bfloat16_rn(e);
      hi[f] = h;
      lo[f] = __float2bfloat16_rn(e - __bfloat162float(h));
    }
  }
}
static unsigned split_grid(int64_t rows) {
  const int64_t blocks = (rows + 7) / 8;
  return (unsigned)(blocks < 4096 ? blocks : 4096);
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

// Row length of B3's bf16 parts: n rounded up to 8 (16-byte rows, so that
// the pass stages them by 16-byte cp.async at every n).
static int split_ld(int n) { return (n + 7) / 8 * 8; }

// Kernel B3.  csq: scratch [k]; xsq: scratch [m]; xh, xl: scratch
// [m, split_ld(n)] bf16; ch, cl: scratch [k, split_ld(n)] bf16; sbest,
// sidx: scratch [ceil(k / bn), m]; bn: centroids per output tile (64 or
// 128); grid: persistent CTAs.
extern "C" int repro_assign_bf16x3(const float* x, const float* c, float* csq,
                                   float* xsq, __nv_bfloat16* xh,
                                   __nv_bfloat16* xl, __nv_bfloat16* ch,
                                   __nv_bfloat16* cl, float* sbest,
                                   int32_t* sidx, int32_t* ids, float* d,
                                   int64_t m, int k, int n, int bn, int grid,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 0) return (int)cudaSuccess;
  REPRO_LAUNCH(sqnorm_rows, sqnorm_grid(k, n), 256, 0, st, c, csq, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ld = split_ld(n);
  REPRO_LAUNCH(split_bf16_rows, split_grid(k + m), 256, 0, st, c, x, ch, cl,
               xh, xl, k, m, n, ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e;  // the pass on the padded rows: their zeros add nothing
  if (bn == 64)
    e = launch_mma_pass<__nv_bfloat16, float, 64, 2>(
        xh, xl, ch, cl, csq, nullptr, sbest, sidx, m, k, ld, grid, st);
  else if (bn == 128)
    e = launch_mma_pass<__nv_bfloat16, float, 128, 2>(
        xh, xl, ch, cl, csq, nullptr, sbest, sidx, m, k, ld, grid, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != (int)cudaSuccess) return e;
  REPRO_LAUNCH(sqnorm_chain_rows, chain_grid(m, n), 256, 0, st, x, xsq, m,
               n);
  REPRO_LAUNCH(assign_fold_f32, fold_grid(m), 256, 0, st, xsq, sbest, sidx,
               ids, d, m, (k + bn - 1) / bn);
  return (int)cudaGetLastError();
}
