// Kernels A-dma, A16-dma, A3-dma, A8-dma: fused_step_*_dma — kernel A (and
// its bf16, bf16x3 and int8 bodies) with the point slabs copied ahead.
//
// Replaces the Pallas kernel repro/kernels/fused_step.py:fused_step_pallas
// with pipeline="dma" (_fused_dma_kernel, :250-289): x stays in HBM and
// point tiles are double-buffered into on-chip memory, the copy of tile
// i+1 started before tile i is computed.  Same math, same results: each
// entry point returns exactly what its pipeline="blocks" twin returns
// (fused_step.cu, fused_step_bf16.cu, fused_step_int8.cu), bit for bit.
//
// Design: the twin's CTA body (common.cuh:fused_cta, fused_cta_q) on the
// twin's grid, with the same point tiles per CTA and the same per-CTA
// partials reduced in CTA order by a second launch; only the slab loader
// differs.  common.cuh:AsyncLoad walks the body's slabs in kernel A's order
// and keeps two staging slots: each load issues the cp.async copies of the
// next slab into the other slot, waits for this slab's, and unpacks it into
// the padded tile the body reads (at n <= 32 the slab is the whole point
// tile, resident across the k loop; above, the x slab of each (k tile,
// feature tile) step, as kernel A re-stages it).  The copies are 4-byte
// words into a dense staging row, unpacked at the row's byte offset: the
// padded tile's row stride (132 bytes at f32, 68 at bf16, 36 at int8) is
// not 16-byte aligned, and a bf16 or int8 row need not start on a word.
// The two slots and the tile do not fit the 48 KB of static shared memory
// (f32: 40,064 B of tile and 67,584 B of slots), so the kernels take
// dynamic shared memory after cudaFuncSetAttribute.
//
// Bound: bytes, as kernel A (x read once: 7.17 MB, 2.14 us at the main
// path's shapes m = 64,000, k = 25, n = 28 in f32; 3.58 MB bf16, 1.79 MB
// int8).  The twins are issue-bound far above it; A-dma overlaps the
// slab's latency with the previous slab's arithmetic and adds an unpack
// pass over shared memory.
#include "common.cuh"

using namespace repro;

// Dynamic shared memory: the body's tile struct, then AsyncLoad's slots.
template <class S, class X>
__device__ __forceinline__ S& dma_tiles(uint32_t*& slots) {
  unsigned char* smem = dynamic_smem();
  slots = reinterpret_cast<uint32_t*>(smem + dma_slots_offset<S>());
  return *reinterpret_cast<S*>(smem);
}

template <class Ops>
__device__ __forceinline__ void fused_dma_cta(
    const typename Ops::X* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ csq, float* __restrict__ part, int64_t m,
    int k, int n, int64_t num_tiles) {
  using X = typename Ops::X;
  uint32_t* slots;
  TileSmemT<Ops>& s = dma_tiles<TileSmemT<Ops>, X>(slots);
  const int64_t stride = (int64_t)k * n + k + 1;
  fused_cta(s, x, c, part + blockIdx.x * stride, m, k, n, num_tiles, csq,
            AsyncLoad<X>(slots, x, m, n, k, Ops::kt, num_tiles));
}

extern "C" __global__ void __launch_bounds__(TM)
fused_step_f32_dma_kernel(const float* __restrict__ x,
                          const float* __restrict__ c,
                          float* __restrict__ part, int64_t m, int k, int n,
                          int64_t num_tiles) {
  fused_dma_cta<F32Ops>(x, c, nullptr, part, m, k, n, num_tiles);
}

extern "C" __global__ void __launch_bounds__(TM)
fused_step_bf16_dma_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ c,
                           const float* __restrict__ csq,
                           float* __restrict__ part, int64_t m, int k, int n,
                           int64_t num_tiles) {
  fused_dma_cta<Bf16Ops>(x, c, csq, part, m, k, n, num_tiles);
}

extern "C" __global__ void __launch_bounds__(TM)
fused_step_bf16x3_dma_kernel(const float* __restrict__ x,
                             const float* __restrict__ c,
                             const float* __restrict__ csq,
                             float* __restrict__ part, int64_t m, int k,
                             int n, int64_t num_tiles) {
  fused_dma_cta<Bf16x3Ops>(x, c, csq, part, m, k, n, num_tiles);
}

extern "C" __global__ void __launch_bounds__(TM)
fused_step_int8_dma_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ c,
                           const float* __restrict__ csq,
                           const float* __restrict__ tq,
                           const float* __restrict__ scale,
                           int32_t* __restrict__ psum, float* __restrict__ pf,
                           int64_t m, int k, int n, int64_t num_tiles) {
  uint32_t* slots;
  TileSmemQ& s = dma_tiles<TileSmemQ, int8_t>(slots);
  const int64_t kn = (int64_t)k * n;
  fused_cta_q(s, x, c, csq, tq, scale, psum + blockIdx.x * kn,
              pf + blockIdx.x * ((int64_t)k + 1), m, k, n, num_tiles,
              AsyncLoad<int8_t>(slots, x, m, n, k, KT, num_tiles));
}

extern "C" __global__ void fused_step_dma_reduce(
    const float* __restrict__ part, float* __restrict__ out, int64_t stride,
    int G) {
  reduce_partials(part, out, stride, G);
}

extern "C" __global__ void fused_step_int8_dma_reduce(
    const int32_t* __restrict__ psum, const float* __restrict__ pf,
    int32_t* __restrict__ osum, float* __restrict__ of, int64_t kn, int k1,
    int G) {
  reduce_partials(psum, osum, kn, G);
  reduce_partials(pf, of, (int64_t)k1, G);
}

// Opt the kernel in to `bytes` of dynamic shared memory.
template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Dynamic shared memory of each dma kernel: 0 f32, 1 bf16, 2 bf16x3, 3 int8.
extern "C" int repro_fused_step_dma_smem_bytes(int policy) {
  switch (policy) {
    case 0: return dma_smem_bytes<TileSmemT<F32Ops>, float>();
    case 1: return dma_smem_bytes<TileSmemT<Bf16Ops>, __nv_bfloat16>();
    case 2: return dma_smem_bytes<TileSmemT<Bf16x3Ops>, float>();
    case 3: return dma_smem_bytes<TileSmemQ, int8_t>();
    default: return -1;
  }
}

// Float bodies.  csq: scratch [k] (unused at f32); part: scratch
// [grid, k*n + k + 1]; out: [k*n + k + 1] = sums (row-major) ++ counts ++
// obj.  The bf16 and bf16x3 bodies first launch sqnorm_rows, as their
// blocks twins do.
template <class Ops, class Kernel>
static int launch_fused_dma(Kernel kernel, const typename Ops::X* x,
                            const float* c, float* csq, float* part,
                            float* out, int64_t m, int k, int n, int grid,
                            void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t stride = (int64_t)k * n + k + 1;
  const int bytes = dma_smem_bytes<TileSmemT<Ops>, typename Ops::X>();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  if constexpr (Ops::csq_given) {
    sqnorm_rows<<<sqnorm_grid(k, n), 256, 0, st>>>(c, csq, k, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, TM, bytes, st>>>(x, c, csq, part, m, k, n, num_tiles);
  } else {
    kernel<<<grid, TM, bytes, st>>>(x, c, part, m, k, n, num_tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_dma_reduce<<<reduce_grid(stride), 256, 0, st>>>(part, out,
                                                             stride, grid);
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_step_f32_dma(const float* x, const float* c,
                                        float* part, float* out, int64_t m,
                                        int k, int n, int grid,
                                        void* stream) {
  return launch_fused_dma<F32Ops>(fused_step_f32_dma_kernel, x, c, nullptr,
                                  part, out, m, k, n, grid, stream);
}

extern "C" int repro_fused_step_bf16_dma(const __nv_bfloat16* x,
                                         const float* c, float* csq,
                                         float* part, float* out, int64_t m,
                                         int k, int n, int grid,
                                         void* stream) {
  return launch_fused_dma<Bf16Ops>(fused_step_bf16_dma_kernel, x, c, csq,
                                   part, out, m, k, n, grid, stream);
}

extern "C" int repro_fused_step_bf16x3_dma(const float* x, const float* c,
                                           float* csq, float* part,
                                           float* out, int64_t m, int k,
                                           int n, int grid, void* stream) {
  return launch_fused_dma<Bf16x3Ops>(fused_step_bf16x3_dma_kernel, x, c, csq,
                                     part, out, m, k, n, grid, stream);
}

// The int8 body, with repro_fused_step_int8's operands: cf [k, n] f32
// centroids; csq scratch [k]; psum scratch [grid, k*n] int32; pf scratch
// [grid, k + 1] f32; osum [k*n] int32 sums; of [k + 1] = counts ++ obj.
extern "C" int repro_fused_step_int8_dma(const int8_t* x, const int8_t* c,
                                         const float* cf, float* csq,
                                         const float* t, const float* scale,
                                         int32_t* psum, float* pf,
                                         int32_t* osum, float* of, int64_t m,
                                         int k, int n, int grid,
                                         void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  const int64_t kn = (int64_t)k * n;
  const int bytes = dma_smem_bytes<TileSmemQ, int8_t>();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = allow_smem(fused_step_int8_dma_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  sqnorm_rows<<<sqnorm_grid(k, n), 256, 0, st>>>(cf, csq, k, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_int8_dma_kernel<<<grid, TM, bytes, st>>>(
      x, c, csq, t, scale, psum, pf, m, k, n, num_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_step_int8_dma_reduce<<<reduce_grid(kn + k + 1), 256, 0, st>>>(
      psum, pf, osum, of, kn, k + 1, grid);
  return (int)cudaGetLastError();
}
