// Kernels B8, B16 and B3 on the tensor cores: the assignment as a wgmma
// product x . c^T with a fused argmin (assign_int8.cu, assign_bf16.cu).
//
// Replace the Pallas kernels repro/kernels/distance.py:_assign_pallas_q
// (int8) and the bf16 and bf16x3 bodies of assign_pallas.  All compute a TN
// product, x [m,n] times c [k,n]^T with both operands K-major (rows of
// features), followed by a row argmin: the shape Hopper's wgmma takes.
//
// Bound: operations.  At the two-pass shape (s = 16,384, k = 2,048,
// n = 1,024) the product is 2 s k n = 68.7 G operations against 35 MB of
// operands (bf16), far above the card's 295 operations per byte; at the
// main path's shape (m = 64,000, k = 25, n = 28) it is bytes.
//
// Design.
//  * A CTA of two consumer warpgroups computes output tiles of MMA_BM = 128
//    rows (64 a warpgroup) by BN = 64 or 128 centroids (the wrapper picks
//    BN from k), persistent over the tiles blockIdx.x, blockIdx.x +
//    gridDim.x, ... (centroid tile fastest, so CTAs in flight share x rows
//    in L2).  Every output tile is one CTA's, so results do not depend on
//    the grid.
//  * Operands reach shared memory in slabs of MMA_SLAB = 128 bytes of each
//    row (64 bf16 or 128 int8 features), laid out as wgmma's 128-byte
//    swizzle expects (K-major, 1024-byte aligned tiles), in a ring of
//    slabs copied ahead of the product (MmaPipe): 16-byte cp.async where
//    the rows and base are 16-byte aligned (the two-pass rows, 1,024 and
//    2,048 bytes), else byte loads stored by the thread (n = 28, 3, 68,
//    1,100 at int8 or bf16).  Bytes past a row and rows past m or k are
//    zeros, exact for both dots.  All 256 threads copy and all multiply:
//    one barrier a slab, no mbarriers.  Each thread copies the same chunk
//    of every 32nd row, so its addresses advance by constant strides.
//  * Each slab is four wgmma of depth 32 bytes: m64nBNk16 f32 += bf16 *
//    bf16 (B16) or m64nBNk32 s32 += s8 * s8 (B8, exact).  B8 accumulates a
//    tile in the wgmma accumulators, one slab's products in flight across
//    the barrier, two CTAs an SM.  B16 adds each slab's products to the
//    tile's sums on the CUDA cores (MmaPipe: the tensor cores' f32
//    accumulation would bias d), one CTA an SM.  B3 (PARTS = 2) stages the
//    bf16 hi and lo parts of both operands (split by a launch before,
//    common.cuh:split_bf16) and takes each slab's three products — x_hi
//    c_lo, x_lo c_hi, then x_hi c_hi, the small ones first so that the
//    tensor cores' truncation sees them against a small running sum — into
//    one partial, added to the tile's sums as B16's.
//  * Epilogue, fused: each thread scores its accumulator fragment in
//    registers (columns j >= k masked by index, never by value), keeps
//    the running (min, lowest index) of its two rows over its columns in
//    increasing order with a strict '<', and the four lanes that share a
//    row fold theirs with shuffles, lowest index among equal minima.  One
//    (best, idx) per row and centroid tile goes to scratch.
//  * A second launch (assign_fold_kernel) folds the centroid tiles of each
//    row in tile order with a strict '<' from (BIG, 0) — the lowest index
//    among equal minima, as kernel B's scan over k — takes ||x||^2 in the
//    order of the kernels before (B8: XlaSum over the dequantized codes;
//    B16: one fmaf partial per 32-feature tile, added in order; B3: one
//    fmaf chain over the f32 row in feature order, sqnorm_chain_rows, read
//    by assign_fold_f32) and writes ids and d = max(best + ||x||^2, 0).
//  * No atomics and no fallback: a launch that fails returns its error.
//
// The device primitives (copies, fences, wgmma, shuffles) sit behind the
// functions below; the host stand-in of the kernel tests
// (tests/test_torch_csrc.py) defines REPRO_HOST_MMA and its own, which
// emulate wgmma on the same fragment layout and hold each product and copy
// until the wait that retires it.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int MMA_BM = 128;       // rows per output tile: two warpgroups
constexpr int MMA_THREADS = 256;  // two consumer warpgroups
constexpr int MMA_SLAB = 128;     // bytes of each row per stage
constexpr int MMA_STEPS = MMA_SLAB / 32;  // wgmma of 32 bytes a slab

// The pipeline of each kernel, by its accumulators.
//   stages  slabs in the ring;
//   flush   false: a tile's products accumulate in the wgmma accumulators,
//           one slab's products left in flight while the next is waited
//           for (stages - 2 slabs copied ahead);
//           true: each slab's products go into partial accumulators from
//           0 and, once retired, are added to the tile's sums on the CUDA
//           cores, rounded to nearest (stages - 1 slabs copied ahead).
//           The tensor cores' f32 accumulation does not round to nearest:
//           over all of n its error grows with the running sum and does
//           not average out (on the card, without the flush, B16's
//           objective lay 1.0e-4 above the plain version's at n = 1,100;
//           tools/profile_assign.py measures it with the flush).  The
//           partials take registers: one CTA an SM instead of two.
template <class Acc, int PARTS = 1>
struct MmaPipe;
template <>
struct MmaPipe<int, 1> {   // B8: exact int32 sums; two CTAs an SM
  static constexpr int stages = 3;
  static constexpr bool flush = false;
  static constexpr int ahead = stages - 2;
};
template <>
struct MmaPipe<float, 1> {  // B16
  static constexpr int stages = 4;
  static constexpr bool flush = true;
  static constexpr int ahead = stages - 1;
};
template <>
struct MmaPipe<float, 2> {  // B3: twice the bytes a slab, one stage fewer
  static constexpr int stages = 3;
  static constexpr bool flush = true;
  static constexpr int ahead = stages - 1;
};

// A ring slot: the x tile(s) of MMA_BM rows, then the c tile(s) of BN rows,
// PARTS of each (B3: hi, then lo).
template <int BN, int PARTS = 1>
__host__ __device__ constexpr int mma_stage_bytes() {
  return PARTS * (MMA_BM + BN) * MMA_SLAB;
}
// Dynamic shared memory of a launch: the ring, and room to align it.
template <class Acc, int BN, int PARTS = 1>
__host__ __device__ constexpr int mma_smem_bytes() {
  return MmaPipe<Acc, PARTS>::stages * mma_stage_bytes<BN, PARTS>() + 1024;
}

#ifndef REPRO_HOST_MMA
// A 16-byte cp.async that copies `bytes` (0 or 16) and zero-fills the rest.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
// This thread's writes to shared memory (cp.async, stores) made visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After a wait: the accumulators are read no earlier than here.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <class Acc, int N>
__device__ __forceinline__ void fence_operands(Acc (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 16 bytes (unused for this layout),
// stride 1,024 bytes between 8-row groups, layout type 1 (128B swizzle).
// Advancing the start by 32 bytes steps one wgmma depth along the row.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// One wgmma of the warpgroup: d (+)= A . B^T with A 64 rows and B N rows
// of 32 bytes each (16 bf16 or 32 int8), both from shared memory; scale_d 0
// overwrites d.  Thread t of the warpgroup holds in register i the element
// (row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
//  col 8 (i / 4) + 2 (t % 4) + i % 2).
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a,
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t a,
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a,
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}


// STEPS wgmma of a slab, from its 32-byte step k0, on the warpgroup's A
// rows `a` and the B tile `b`; `accumulate` false starts d from 0.
template <int STEPS, class Acc, int N>
__device__ __forceinline__ void mma_steps(Acc (&d)[N], const unsigned char* a,
                                          const unsigned char* b, int k0,
                                          bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma(d, smem_desc(a + 32 * (k0 + kk)), smem_desc(b + 32 * (k0 + kk)),
          (accumulate || kk > 0) ? 1 : 0);
}
#endif  // REPRO_HOST_MMA

// The tile's sums d after the partials of its slab `kslab` (the first
// taken as they are), once their products are retired.
template <class Acc, int N>
__device__ __forceinline__ void add_partials(Acc (&d)[N], Acc (&part)[N],
                                             int kslab) {
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < N; ++i)
    d[i] = kslab > 0 ? __fadd_rn(d[i], part[i]) : part[i];
}

// Stage bytes [kb, kb + MMA_SLAB) of rows [row0, row0 + ROWS) of g
// (row-major, rb bytes a row, `total` rows) into a 1024-byte aligned tile:
// row r's 16-byte chunk q lands at r * MMA_SLAB + ((q ^ (r % 8)) * 16),
// wgmma's 128-byte swizzle.  Bytes past the row and rows past `total` are
// zeros.  Thread t copies chunk t % 8 of rows t / 8 + 32 i, so its chunk's
// place in a row (and in the swizzle) is the same for every i.  vec:
// 16-byte cp.async (rows and base 16-byte aligned); else byte loads, stored
// by the thread at once.
template <int ROWS>
__device__ __forceinline__ void stage_slab(unsigned char* tile,
                                           const unsigned char* __restrict__ g,
                                           int64_t total, int64_t rb,
                                           int64_t row0, int64_t kb,
                                           bool vec) {
  static_assert(ROWS % 32 == 0, "a pass of the CTA covers 32 rows");
  const int r0 = threadIdx.x / 8;
  const int ch = threadIdx.x % 8;
  const int64_t off = kb + 16 * ch;
  const bool in_row = off < rb;
  unsigned char* dst = tile + r0 * MMA_SLAB + ((ch ^ (r0 & 7)) << 4);
  const unsigned char* src = g + (row0 + r0) * rb + off;
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const bool in = in_row && row0 + r0 + 32 * i < total;
    unsigned char* d = dst + 32 * i * MMA_SLAB;
    const unsigned char* p = src + 32 * i * rb;
    if (vec) {
      cp_async16_zfill(d, in ? p : g, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const int nb = rb - off < 16 ? (int)(rb - off) : 16;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (j < nb) w[j >> 2] |= (uint32_t)p[j] << (8 * (j & 3));
      }
      uint4 v;
      v.x = w[0];
      v.y = w[1];
      v.z = w[2];
      v.w = w[3];
      *reinterpret_cast<uint4*>(d) = v;
    }
  }
}

// The score of centroid `col` from its accumulated dot: B16, csq - 2 dot
// (kernel B16's before); B8, csq - 2 (float(idot) t), rounded as the
// reference's oracle rounds it (common.cuh:tile_argmin_q).
__device__ __forceinline__ float mma_score(float dot, int col,
                                           const float* __restrict__ csq,
                                           const float* __restrict__) {
  return csq[col] - 2.f * dot;
}
__device__ __forceinline__ float mma_score(int idot, int col,
                                           const float* __restrict__ csq,
                                           const float* __restrict__ tq) {
  return __fsub_rn(csq[col], 2.f * __fmul_rn((float)idot, tq[col]));
}

// (best, idx) <- (v, i) if v is smaller, or equal with a lower index.
__device__ __forceinline__ void take_lower(float& best, int& idx, float v,
                                           int i) {
  if (v < best || (v == best && i < idx)) {
    best = v;
    idx = i;
  }
}

// The fused argmin of one output tile (row tile rt, centroid tile nt) from
// the accumulators d: per row the (min, lowest index) over the tile's
// columns j < k, to sbest / sidx [ntiles, m].  Every thread of the CTA
// calls it.
template <class Acc, int N>
__device__ __forceinline__ void mma_epilogue(
    const Acc (&d)[N], int64_t rt, int nt, const float* __restrict__ csq,
    const float* __restrict__ tq, float* __restrict__ sbest,
    int32_t* __restrict__ sidx, int64_t m, int k) {
  const int wt = threadIdx.x % 128;
  const int lane = wt % 32;
  const int64_t row = rt * MMA_BM + (threadIdx.x / 128) * 64 +
                      (wt / 32) * 16 + lane / 4;
  const int col0 = nt * (2 * N) + 2 * (lane % 4);
  float best[2] = {BIG, BIG};
  int idx[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < N; ++i) {  // columns in increasing order per row
    const int col = col0 + 8 * (i / 4) + i % 2;
    const int h = (i / 2) % 2;   // row, or row + 8
    if (col < k) {
      const float s = mma_score(d[i], col, csq, tq);
      if (s < best[h]) {
        best[h] = s;
        idx[h] = col;
      }
    }
  }
#pragma unroll
  for (int mask = 1; mask <= 2; mask <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[h], mask);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[h], mask);
      take_lower(best[h], idx[h], ob, oi);
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row + 8 * h;
      if (r < m) {
        sbest[(int64_t)nt * m + r] = best[h];
        sidx[(int64_t)nt * m + r] = idx[h];
      }
    }
  }
}

// The tensor-core pass: for each output tile of this CTA, the product over
// all slabs of n, then the fused argmin.  X: int8_t (Acc int) or
// __nv_bfloat16 (Acc float); c the centroids in X (codes, or bf16(c)).
// PARTS = 2 (B3): x and c the bf16 hi parts, xlo and clo the lo parts (else
// unused).
template <class X, class Acc, int BN, int PARTS = 1>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    assign_mma_kernel(const X* __restrict__ x, const X* __restrict__ xlo,
                      const X* __restrict__ c, const X* __restrict__ clo,
                      const float* __restrict__ csq,
                      const float* __restrict__ tq, float* __restrict__ sbest,
                      int32_t* __restrict__ sidx, int64_t m, int k, int n,
                      int ntiles) {
  using Pipe = MmaPipe<Acc, PARTS>;
  constexpr int slot_bytes = mma_stage_bytes<BN, PARTS>();
  constexpr int xtile = MMA_BM * MMA_SLAB;   // bytes of one x tile
  constexpr int ctile = BN * MMA_SLAB;       // bytes of one c tile
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dynamic_smem()) + 1023) &
      ~(uintptr_t)1023);
  const int64_t rb = (int64_t)n * (int64_t)sizeof(X);
  const int ks = (int)((rb + MMA_SLAB - 1) / MMA_SLAB);  // slabs per tile
  const int64_t tiles = (m + MMA_BM - 1) / MMA_BM * ntiles;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t slabs = mine * ks;
  auto aligned = [&](const X* p) {
    return PARTS == 1 || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool xvec = rb % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 && aligned(xlo);
  const bool cvec = rb % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(c) % 16 == 0 && aligned(clo);
  auto tile_of = [&](int64_t s) { return blockIdx.x + (s / ks) * gridDim.x; };
  auto stage = [&](int64_t s) {  // copy slab s into its ring slot
    if (s < slabs) {
      const int64_t tile = tile_of(s);
      const int64_t kb = (s % ks) * MMA_SLAB;
      unsigned char* a = smem + (s % Pipe::stages) * slot_bytes;
      const X* xs[2] = {x, xlo};
      const X* cs[2] = {c, clo};
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        stage_slab<MMA_BM>(a + p * xtile,
                           reinterpret_cast<const unsigned char*>(xs[p]), m,
                           rb, tile / ntiles * MMA_BM, kb, xvec);
        stage_slab<BN>(a + PARTS * xtile + p * ctile,
                       reinterpret_cast<const unsigned char*>(cs[p]), k, rb,
                       tile % ntiles * BN, kb, cvec);
      }
    }
    cp_async_commit();
  };
  constexpr int ahead = Pipe::ahead;
  Acc d[BN / 2];
  Acc part[Pipe::flush ? BN / 2 : 1];
  const int wg = threadIdx.x / 128;
  for (int s = 0; s < ahead; ++s) stage(s);
  for (int64_t s = 0; s < slabs; ++s) {
    cp_async_wait<ahead - 1>();  // this thread's copies of slab s ...
    fence_proxy_async();
    __syncthreads();  // ... everyone's; the last products' slot is free
    stage(s + ahead);  // into slab s + ahead - stages's slot
    const unsigned char* a = smem + (s % Pipe::stages) * slot_bytes;
    const unsigned char* ax = a + wg * 64 * MMA_SLAB;  // this warpgroup's
    const unsigned char* bc = a + PARTS * xtile;       // rows; the c tile
    const int kslab = (int)(s % ks);
    wgmma_fence();
    if constexpr (Pipe::flush) {
      if constexpr (PARTS == 2) {  // x_hi c_lo, x_lo c_hi, then x_hi c_hi
        mma_steps<MMA_STEPS>(part, ax, bc + ctile, 0, false);
        mma_steps<MMA_STEPS>(part, ax + xtile, bc, 0, true);
        mma_steps<MMA_STEPS>(part, ax, bc, 0, true);
      } else {
        mma_steps<MMA_STEPS>(part, ax, bc, 0, false);
      }
      wgmma_commit();
      wgmma_wait<0>();
      add_partials(d, part, kslab);
    } else {
      mma_steps<MMA_STEPS>(d, ax, bc, 0, kslab > 0);
      wgmma_commit();
    }
    if (kslab == ks - 1) {
      wgmma_wait<0>();
      fence_operands(d);
      const int64_t tile = tile_of(s);
      mma_epilogue(d, tile / ntiles, (int)(tile % ntiles), csq, tq, sbest,
                   sidx, m, k);
    } else if constexpr (!Pipe::flush) {
      wgmma_wait<1>();  // slab s - 1's products retired
    }
  }
  cp_async_wait<0>();
}

// ||x||^2 of a bf16 row as the kernels before B16 took it
// (common.cuh:Bf16Ops::xsq_by_tile): one fmaf partial per FT-feature tile,
// from 0 in feature order, the partials added in tile order from 0.
template <class Value>
__device__ __forceinline__ float tile_sqsum(int n, Value value) {
  float total = 0.f;
  for (int f0 = 0; f0 < n; f0 += FT) {
    float part = 0.f;
    const int end = min(f0 + FT, n);
    for (int f = f0; f < end; ++f) {
      const float v = value(f);
      part = fmaf(v, v, part);
    }
    total += part;
  }
  return total;
}
// Shared memory of the fold's warp-a-row mode: one segment of 32 windows
// (a window a lane) of each of the block's 8 rows, and for int8 the
// segment's scales.  Window rows are padded to an odd number of words, so
// that the lanes' reads of their windows fall on different banks.
constexpr int FOLD_ROWS = 256 / 32;
template <class X>
struct FoldSmem {
  static constexpr int pad = 4 / (int)sizeof(X);   // 36 or 68 bytes a row
  X xs[FOLD_ROWS][32][32 + pad];
  float sc[32][33];
};

// The fold: ids and d of each row from its centroid tiles' (best, idx), in
// tile order with a strict '<' from (BIG, 0), and ||x||^2 in the order of
// the kernels before (Q, int8: XlaSum of (xq scale)^2; bf16: tile_sqsum).
// Blocks of 256 threads, rows_per_block(n) rows a block: for n <= 32 a
// thread a row; else a warp a row, the row read in segments of 32 windows
// of 32 features (the int8 windows of XlaSum, offset by its padding, or
// the bf16 feature tiles), each staged in shared memory by coalesced loads
// and summed there, a window a lane.
template <class X, bool Q>
__global__ void assign_fold_kernel(const X* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ sbest,
                                   const int32_t* __restrict__ sidx,
                                   int32_t* __restrict__ ids,
                                   float* __restrict__ d, int64_t m, int n,
                                   int ntiles) {
  __shared__ FoldSmem<X> fs;
  const int per = rows_per_block(n);
  const int64_t r = (int64_t)blockIdx.x * per + threadIdx.x * per / 256;
  const bool live = r < m;
  const X* row = x + (live ? r : 0) * n;
  float xsq;
  if (per == 256) {
    if constexpr (Q) {
      xsq = sum_in_order(0, n, [&](int f) {
        const float dq = __fmul_rn((float)row[f], scale[f]);
        return __fmul_rn(dq, dq);
      });
    } else {
      xsq = tile_sqsum(n, [&](int f) { return __bfloat162float(row[f]); });
    }
  } else {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    XlaSum acc(n);                         // int8: the windows' levels
    const int lo = Q ? acc.lo[0] : 0;      // bf16 tiles start at 0
    const int windows = (n + 31) / 32;
    float total = 0.f;                     // one level: the sum in order
    for (int base = 0; base < windows; base += 32) {
      __syncthreads();                     // the segment before was read
      const int f0 = 32 * base - lo;
      for (int e = lane; e < 32 * 32; e += 32) {
        const int f = f0 + e;
        fs.xs[warp][e / 32][e % 32] =
            (live && f >= 0 && f < n) ? row[f] : X();
      }
      if constexpr (Q) {
        for (int e = threadIdx.x; e < 32 * 32; e += 256) {
          const int f = f0 + e;
          fs.sc[e / 32][e % 32] = (f >= 0 && f < n) ? scale[f] : 0.f;
        }
      }
      __syncthreads();
      float s = 0.f;                       // window base + lane, in order
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if constexpr (Q) {
          const float dq =
              __fmul_rn((float)fs.xs[warp][lane][j], fs.sc[lane][j]);
          s = __fadd_rn(s, __fmul_rn(dq, dq));
        } else {
          const float v = __bfloat162float(fs.xs[warp][lane][j]);
          s = fmaf(v, v, s);
        }
      }
      for (int src = 0; src < 32 && base + src < windows; ++src) {
        const float v = __shfl_sync(0xffffffffu, s, src);
        if (!Q) {
          total += v;
        } else if (acc.top == 1) {
          total = __fadd_rn(total, v);
        } else if (lane == 0) {
          acc.push(v, 1);
        }
      }
    }
    xsq = Q && acc.top > 1 ? acc.finish(1) : total;
  }
  if (!live || (per != 256 && (threadIdx.x & 31) != 0)) return;
  float best = BIG;
  int bidx = 0;
  for (int t = 0; t < ntiles; ++t) {
    const float v = sbest[(int64_t)t * m + r];
    if (v < best) {
      best = v;
      bidx = sidx[(int64_t)t * m + r];
    }
  }
  ids[r] = bidx;
  d[r] = fmaxf(best + xsq, 0.f);
}

// The tensor-core pass over ntiles = ceil(k / BN) centroid tiles of BN = 64
// or 128 on `grid` persistent CTAs.  Returns a CUDA error code.
template <class X, class Acc, int BN, int PARTS = 1>
static int launch_mma_pass(const X* x, const X* xlo, const X* c,
                           const X* clo, const float* csq, const float* tq,
                           float* sbest, int32_t* sidx, int64_t m, int k,
                           int n, int grid, cudaStream_t st) {
  const int ntiles = (k + BN - 1) / BN;
  auto pass = assign_mma_kernel<X, Acc, BN, PARTS>;
  constexpr int smem = mma_smem_bytes<Acc, BN, PARTS>();
  const cudaError_t err = cudaFuncSetAttribute(
      pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  REPRO_LAUNCH(pass, grid, MMA_THREADS, smem, st, x, xlo, c, clo, csq, tq,
               sbest, sidx, m, k, n, ntiles);
  return (int)cudaGetLastError();
}

// B8 and B16 after the norms: the tensor-core pass, then the fold.
template <class X, class Acc, bool Q, int BN>
static int launch_mma_bn(const X* x, const X* c, const float* csq,
                         const float* tq, const float* scale, float* sbest,
                         int32_t* sidx, int32_t* ids, float* d, int64_t m,
                         int k, int n, int grid, cudaStream_t st) {
  const int err = launch_mma_pass<X, Acc, BN>(
      x, nullptr, c, nullptr, csq, tq, sbest, sidx, m, k, n, grid, st);
  if (err != (int)cudaSuccess) return err;
  auto fold = assign_fold_kernel<X, Q>;
  REPRO_LAUNCH(fold, sqnorm_grid(m, n), 256, 0, st, x, scale, sbest, sidx,
               ids, d, m, n, (k + BN - 1) / BN);
  return (int)cudaGetLastError();
}

template <class X, class Acc, bool Q>
static int launch_assign_mma(const X* x, const X* c, const float* csq,
                             const float* tq, const float* scale,
                             float* sbest, int32_t* sidx, int32_t* ids,
                             float* d, int64_t m, int k, int n, int bn,
                             int grid, cudaStream_t st) {
  if (m == 0) return (int)cudaSuccess;
  if (bn == 64)
    return launch_mma_bn<X, Acc, Q, 64>(x, c, csq, tq, scale, sbest, sidx,
                                        ids, d, m, k, n, grid, st);
  if (bn == 128)
    return launch_mma_bn<X, Acc, Q, 128>(x, c, csq, tq, scale, sbest, sidx,
                                         ids, d, m, k, n, grid, st);
  return (int)cudaErrorInvalidValue;
}

// csq[r] = ||c_r||^2 for `rows` f32 rows of n features as kernel B's
// CUDA-core body took it for x and for c (common.cuh:tile_argmin under
// F32Ops): one fmaf chain from 0 in feature order.  Blocks of 256 threads
// (chain_grid).  For n <= 32 a thread a row; else a block takes CHAIN_ROWS
// rows in chunks of CHAIN_F features: all its warps stage a chunk in shared
// memory by coalesced loads, then lane i of warp 0 continues row i's chain
// over it.
constexpr int CHAIN_ROWS = 32;
constexpr int CHAIN_F = 256;
static __global__ void __launch_bounds__(256)
    sqnorm_chain_rows(const float* __restrict__ c, float* __restrict__ csq,
                      int64_t rows, int n) {
  if (n <= 32) {
    const int64_t r = (int64_t)blockIdx.x * 256 + threadIdx.x;
    if (r < rows) {
      const float* row = c + r * n;
      float s = 0.f;
      for (int f = 0; f < n; ++f) s = fmaf(row[f], row[f], s);
      csq[r] = s;
    }
    return;
  }
  __shared__ float buf[CHAIN_ROWS][CHAIN_F + 1];  // odd stride: the chain's
  const int warp = threadIdx.x / 32;              // reads on 32 banks
  const int lane = threadIdx.x % 32;
  const int64_t r0 = (int64_t)blockIdx.x * CHAIN_ROWS;
  float s = 0.f;
  for (int f0 = 0; f0 < n; f0 += CHAIN_F) {
    __syncthreads();  // the chunk before was read
#pragma unroll
    for (int i = 0; i < CHAIN_ROWS / 8; ++i) {
      const int row = warp + 8 * i;
      const bool live = r0 + row < rows;
      const float* src = c + (live ? r0 + row : 0) * n + f0;
#pragma unroll
      for (int j = 0; j < CHAIN_F / 32; ++j) {
        const int f = lane + 32 * j;
        buf[row][f] = live && f0 + f < n ? src[f] : 0.f;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int e = min(CHAIN_F, n - f0);
      for (int f = 0; f < e; ++f) s = fmaf(buf[lane][f], buf[lane][f], s);
    }
  }
  if (warp == 0 && r0 + lane < rows) csq[r0 + lane] = s;
}
inline unsigned chain_grid(int64_t rows, int n) {
  const int per = n <= 32 ? 256 : CHAIN_ROWS;
  return (unsigned)((rows + per - 1) / per);
}

// The fold of kernels B (more than one centroid tile) and B3: ids and d of
// each row from its centroid tiles' (best, idx) [ntiles, m], in tile order
// with a strict '<' from (BIG, 0), and ||x||^2 = xsq[r] (sqnorm_chain_rows'
// order: B's pass takes it, B3 a launch before).  A thread a row, blocks of
// 256 (fold_grid).
static __global__ void assign_fold_f32(const float* __restrict__ xsq,
                                       const float* __restrict__ sbest,
                                       const int32_t* __restrict__ sidx,
                                       int32_t* __restrict__ ids,
                                       float* __restrict__ d, int64_t m,
                                       int ntiles) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  float best = BIG;
  int bidx = 0;
  for (int t = 0; t < ntiles; ++t) {
    const float v = sbest[(int64_t)t * m + r];
    if (v < best) {
      best = v;
      bidx = sidx[(int64_t)t * m + r];
    }
  }
  ids[r] = bidx;
  d[r] = fmaxf(best + xsq[r], 0.f);
}
inline unsigned fold_grid(int64_t rows) {
  return (unsigned)((rows + 255) / 256);
}

}  // namespace repro
