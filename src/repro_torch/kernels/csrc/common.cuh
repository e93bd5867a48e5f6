// Shared device code of the kernels: the float CTA bodies (fused_step.cu,
// fused_step_batched.cu and their bf16 / bf16x3 twins *_bf16.cu) and the
// int8 bodies (fused_step_int8.cu, fused_step_batched_int8.cu), and the
// norms and copies the assign kernels share (assign*.cu, assign_mma.cuh).
// The update kernels (update*.cu) have their own, update.cuh.
//
// One CTA of TM threads walks point tiles of TM rows; thread t owns row t of
// the tile.  Point and centroid tiles are staged in shared memory, k-tiled by
// Ops::kt centroids and n-tiled by FT features, so any (k, n) runs with a
// fixed, static amount of shared memory.
//
// The float bodies are templates over an operand policy (F32Ops, Bf16Ops,
// Bf16x3Ops): how x is stored, how the centroid tile is staged and how a
// product is accumulated.  Everything else — tiling, the tie rule, the
// one-hot contraction, the ordered reductions — is one code path.
//
// Determinism: nothing here uses atomics.  Every sum is taken by one thread
// in a fixed order, and cross-CTA sums go through per-CTA partials that a
// second launch reduces in CTA order, so two launches on the same inputs
// (on the same card) give bitwise equal results.
//
// How a point slab reaches s.xs is the body's `Load` parameter: SyncLoad
// (kernels A-D and their twins) reads it from global memory when the body
// asks for it; AsyncLoad (the dma kernels, fused_step_dma.cu) has copied it
// ahead into a staging slot with cp.async while the body computed on the
// slab before.  Either way s.xs holds the same values, so the arithmetic,
// and the result, is the same.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// A launch of `kernel` on `stream`; the host stand-in of the kernel tests
// defines REPRO_HOST_LAUNCH and runs the CTAs itself.
#ifndef REPRO_HOST_LAUNCH
#define REPRO_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

constexpr int TM = 256;       // points per tile == threads per CTA
constexpr int KT = 32;        // centroids per k tile (register accumulators)
constexpr int FT = 32;        // features per feature tile
constexpr float BIG = 1e30f;  // initial best score (fused_step.py:_BIG)

// bf16(v) as a float: round to nearest, ties to even (XLA's and torch's
// f32 -> bf16 conversion).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// hi = bf16(v), lo = bf16(v - hi) (precision.py:_split_bf16); v - hi is
// exact in f32.
__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = round_bf16(v);
  lo = round_bf16(v - hi);
}

// --------------------------------------------------------------------------
// Operand policies.  Each gives:
//   X           the element type of x in device and shared memory;
//   kt          centroids per k tile (its accumulators live in registers);
//   xpad        padding of a shared x row, so that the row-per-thread reads
//               of a warp fall on 32 different banks;
//   csq_given   ||c||^2 comes from a full-width f32 array csq (a first
//               launch, sqnorm_rows) instead of the staged tile;
//   xsq_by_tile ||x||^2 adds one partial sum per feature tile instead of
//               every square: a sequential f32 sum of bf16 squares, whose
//               low bits are not random, rounds with a bias (-5.6e-5 of d
//               at n = 1,024, where d is 26 times smaller than ||x||^2);
//   split       the product is the bf16x3 sum of three bf16 products;
//   CTile       the staged centroid tile, stage() writes one element of it;
//   Acc, madd   the k tile's dot accumulators and one feature's update;
//   dot         the finished dot of centroid j;
//   widen       a stored x element as f32.
// --------------------------------------------------------------------------

// Kernels A-D: true fp32, sequential FMAs over the features.
struct F32Ops {
  using X = float;
  static constexpr int kt = KT;
  static constexpr int xpad = 1;
  static constexpr bool csq_given = false;
  static constexpr bool xsq_by_tile = false;
  static constexpr bool split = false;
  struct CTile {
    float cs[KT][FT];  // centroid tile (broadcast reads)
  };
  struct Acc {
    float a[KT];
  };
  __device__ static float widen(float v) { return v; }
  __device__ static void stage(CTile& ct, int j, int col, float v) {
    ct.cs[j][col] = v;
  }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < KT; ++j) acc.a[j] = 0.f;
  }
  __device__ static void madd(Acc& acc, float xv, const CTile& ct, int f) {
#pragma unroll
    for (int j = 0; j < KT; ++j) acc.a[j] = fmaf(xv, ct.cs[j][f], acc.a[j]);
  }
  __device__ static float dot(const Acc& acc, int j) { return acc.a[j]; }
};

// Kernels A16-D16 (precision 'bf16'): x stored bf16 (half the bytes), c
// rounded to bf16 as it is staged, products accumulated in f32.  A product
// of two bf16 values is exact in f32, so fmaf rounds once, as an f32
// accumulation of bf16 x bf16 products does.  ||c||^2 from the f32
// centroids (csq), ||x||^2 from the stored bf16 values.
struct Bf16Ops {
  using X = __nv_bfloat16;
  static constexpr int kt = KT;
  static constexpr int xpad = 2;  // a 68-byte row stride (17 words, odd)
  static constexpr bool csq_given = true;
  static constexpr bool xsq_by_tile = true;
  static constexpr bool split = false;
  struct CTile {
    float cs[KT][FT];  // bf16(c) as floats
  };
  using Acc = F32Ops::Acc;
  __device__ static float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static void stage(CTile& ct, int j, int col, float v) {
    ct.cs[j][col] = round_bf16(v);
  }
  __device__ static void zero(Acc& acc) { F32Ops::zero(acc); }
  __device__ static void madd(Acc& acc, float xv, const CTile& ct, int f) {
#pragma unroll
    for (int j = 0; j < KT; ++j) acc.a[j] = fmaf(xv, ct.cs[j][f], acc.a[j]);
  }
  __device__ static float dot(const Acc& acc, int j) { return acc.a[j]; }
};

// Kernels A3-D3 (precision 'bf16x3'): x and c stored f32 and split into
// bf16 hi + lo; three accumulators hh = sum xh ch, hl = sum xh cl,
// lh = sum xl ch, each exact products accumulated in f32, added as
// (hh + hl) + lh — the reference's association (precision.py:dot).
// ||c||^2 from the f32 centroids (csq), ||x||^2 from the f32 values.  A k
// tile of KT3 = 16 centroids: with KT's 3 x 32 accumulators ptxas spilled.
constexpr int KT3 = 16;
struct Bf16x3Ops {
  using X = float;
  static constexpr int kt = KT3;
  static constexpr int xpad = 1;
  static constexpr bool csq_given = true;
  static constexpr bool xsq_by_tile = false;
  static constexpr bool split = true;
  struct CTile {
    float hi[KT3][FT];  // bf16(c)
    float lo[KT3][FT];  // bf16(c - hi)
  };
  struct Acc {
    float hh[KT3], hl[KT3], lh[KT3];
  };
  __device__ static float widen(float v) { return v; }
  __device__ static void stage(CTile& ct, int j, int col, float v) {
    split_bf16(v, ct.hi[j][col], ct.lo[j][col]);
  }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < KT3; ++j) acc.hh[j] = acc.hl[j] = acc.lh[j] = 0.f;
  }
  __device__ static void madd(Acc& acc, float xv, const CTile& ct, int f) {
    float xh, xl;
    split_bf16(xv, xh, xl);
#pragma unroll
    for (int j = 0; j < KT3; ++j) {
      acc.hh[j] = fmaf(xh, ct.hi[j][f], acc.hh[j]);
      acc.hl[j] = fmaf(xh, ct.lo[j][f], acc.hl[j]);
      acc.lh[j] = fmaf(xl, ct.hi[j][f], acc.lh[j]);
    }
  }
  __device__ static float dot(const Acc& acc, int j) {
    return (acc.hh[j] + acc.hl[j]) + acc.lh[j];
  }
};

template <class Ops>
struct TileSmemT {
  typename Ops::X xs[TM][FT + Ops::xpad];  // point tile (row-per-thread)
  typename Ops::CTile ct;                  // centroid tile
  float c2[Ops::kt];                       // ||c||^2 of the current k tile
  int ids[TM];    // tile assignment; -1 never matches a cluster
  float red[TM];  // block-reduction scratch
};

using TileSmem = TileSmemT<F32Ops>;

// Stage x[r0 : r0+TM, f0 : f0+fw] into s.xs; rows past m read as 0.  `S` is
// a TileSmemT or TileSmemQ, `X` its element type.
template <class S, class X>
__device__ __forceinline__ void load_x_tile(S& s, const X* __restrict__ x,
                                            int64_t m, int n, int64_t r0,
                                            int f0, int fw) {
  for (int q = threadIdx.x; q < TM * fw; q += TM) {
    const int row = q / fw;
    const int col = q - row * fw;
    const int64_t r = r0 + row;
    s.xs[row][col] = r < m ? x[r * n + f0 + col] : X();
  }
}

// The slab loader of kernels A-D and their twins: the slab is read from
// global memory when the body asks for it.
struct SyncLoad {
  template <class S, class X>
  __device__ __forceinline__ void load(S& s, const X* __restrict__ x,
                                       int64_t m, int n, int64_t r0, int f0,
                                       int fw) {
    load_x_tile(s, x, m, n, r0, f0, fw);
  }
  __device__ __forceinline__ void finish() {}
};

// The copy primitives of AsyncLoad: an asynchronous 4-byte copy global ->
// shared (cp.async), the commit of the copies issued so far as one group,
// and the wait until at most N of this thread's groups are in flight; and
// the launch's dynamic shared memory.  (The host stand-in of the kernel
// tests defines REPRO_HOST_ASYNC_COPY and its own.)
#ifndef REPRO_HOST_ASYNC_COPY
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char repro_dynamic_smem[];
  return repro_dynamic_smem;
}
#endif

// The slab loader of the dma kernels (A-dma under each policy): the
// reference's pipeline="dma" (fused_step.py:_fused_dma_kernel) on Hopper.
// The CTA body asks for its slabs in kernel A's order; AsyncLoad knows that
// order, so each load() issues the copy of the NEXT slab into the other
// staging slot before it waits for this one, and the copy runs while the
// body computes.  The order, per point tile (tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...):
//   n <= FT: one slab, the whole tile (rows r0..r0+TM, all n features); it
//            stays in s.xs across the k loop and the one-hot contraction,
//            so later loads of the same tile return at once;
//   n >  FT: tile_argmin's (k tile, feature tile) slabs, then
//            tile_accumulate's feature tiles: nf * (k tiles + 1) slabs, the
//            slab of step j holding feature tile j % nf.
// A staging row is the 4-byte words that cover one row's segment
// x[r, f0 : f0+fw] (rows are n*sizeof(X) bytes, so a bf16 or int8 segment
// need not start on a word; cp.async copies 4, 8 or 16 aligned bytes): at
// most W words, copied densely, then unpacked into the padded s.xs at the
// segment's byte offset.  The words of the first and last row may reach up
// to 3 bytes before or after x; an aligned word that holds a byte of x lies
// in its page, so the read cannot fault, and those bytes are never used.
// Rows past m are not copied and unpack as 0, as load_x_tile makes them.
template <class X>
struct AsyncLoad {
  static constexpr int W = FT * (int)sizeof(X) / 4 + 1;  // words per row
  uint32_t* buf;        // staging, [2 slots][TM rows][W words]
  const X* x;
  int64_t m;
  int n;
  int nf;               // feature tiles
  int steps;            // slabs per point tile
  int64_t num_tiles;
  int64_t tile;         // point tile of the slab in `slot`
  int step;             // its step within the tile
  int slot;
  int64_t staged_r0;    // first row of the slab in s.xs, or -1

  // Issues the CTA's first slab.  kt: centroids per k tile of the body.
  __device__ __forceinline__ AsyncLoad(uint32_t* buf_, const X* x_,
                                       int64_t m_, int n_, int k, int kt,
                                       int64_t num_tiles_)
      : buf(buf_), x(x_), m(m_), n(n_), nf((n_ + FT - 1) / FT),
        steps(n_ <= FT ? 1 : nf * ((k + kt - 1) / kt + 1)),
        num_tiles(num_tiles_), tile(blockIdx.x), step(0), slot(0),
        staged_r0(-1) {
    if (tile < num_tiles) issue(0, tile, 0);
    cp_async_commit();
  }

  // cp.async the words covering x[t*TM + row, f0 : f0+fw], rows < m, into
  // staging slot `sl` (one thread per word, as load_x_tile's elements).
  __device__ __forceinline__ void issue(int sl, int64_t t, int f0) {
    const int64_t r0 = t * TM;
    const int bytes = min(FT, n - f0) * (int)sizeof(X);
    uint32_t* dst = buf + (int64_t)sl * TM * W;
    for (int q = threadIdx.x; q < TM * W; q += TM) {
      const int row = q / W;
      const int w = q - row * W;
      const int64_t r = r0 + row;
      if (r >= m) continue;
      const uintptr_t a = reinterpret_cast<uintptr_t>(x + r * n + f0);
      const uintptr_t a0 = a & ~(uintptr_t)3;
      const int nw = (int)(((a + bytes + 3) & ~(uintptr_t)3) - a0) / 4;
      if (w < nw)
        cp_async4(dst + row * W + w,
                  reinterpret_cast<const void*>(a0 + 4 * (uintptr_t)w));
    }
  }

  // s.xs = x[r0 : r0+TM, f0 : f0+fw], the slab in `slot` (the body's next
  // slab in kernel A's order), with the copy of the slab after it issued
  // first.  Every thread of the CTA calls it; it synchronises.
  template <class S>
  __device__ __forceinline__ void load(S& s, const X* __restrict__, int64_t,
                                       int, int64_t r0, int f0, int fw) {
    if (steps == 1 && r0 == staged_r0) return;  // the tile is resident
    int64_t next_tile = tile;
    int next_step = step + 1;
    if (next_step == steps) {
      next_tile += gridDim.x;
      next_step = 0;
    }
    if (next_tile < num_tiles)
      issue(slot ^ 1, next_tile, (next_step % nf) * FT);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of the slab in `slot` ...
    __syncthreads();     // ... and every thread's have landed
    const uint32_t* src = buf + (int64_t)slot * TM * W;
    for (int q = threadIdx.x; q < TM * fw; q += TM) {
      const int row = q / fw;
      const int col = q - row * fw;
      const int64_t r = r0 + row;
      X v = X();
      if (r < m) {
        const int off =
            (int)(reinterpret_cast<uintptr_t>(x + r * n + f0) & 3);
        v = *reinterpret_cast<const X*>(
            reinterpret_cast<const unsigned char*>(src + row * W) + off +
            col * (int)sizeof(X));
      }
      s.xs[row][col] = v;
    }
    tile = next_tile;
    step = next_step;
    slot ^= 1;
    staged_r0 = r0;
  }

  __device__ __forceinline__ void finish() { cp_async_wait<0>(); }
};

// Dynamic shared memory of a dma kernel whose tiles are an `S` over
// elements `X`: S, rounded up to 16 bytes, then AsyncLoad's two slots.
template <class S>
__host__ __device__ constexpr int dma_slots_offset() {
  return ((int)sizeof(S) + 15) / 16 * 16;
}
template <class S, class X>
__host__ __device__ constexpr int dma_smem_bytes() {
  return dma_slots_offset<S>() + 2 * TM * AsyncLoad<X>::W * 4;
}

// Stage c[k0 : k0+kt, f0 : f0+fw] (f32) into s.ct; rows past k and columns
// past fw read as 0.
template <class Ops>
__device__ __forceinline__ void load_c_tile(TileSmemT<Ops>& s,
                                            const float* __restrict__ c,
                                            int k, int n, int k0, int f0,
                                            int fw) {
  for (int q = threadIdx.x; q < Ops::kt * FT; q += TM) {
    const int j = q / FT;
    const int col = q - j * FT;
    Ops::stage(s.ct, j, col,
               (k0 + j < k && col < fw) ? c[(int64_t)(k0 + j) * n + f0 + col]
                                        : 0.f);
  }
}

// Nearest centroid of row r0 + threadIdx.x: the running (min, argmin) of
// score_j = ||c_j||^2 - 2 x.c_j over all k, with a strict '<' so that a tie
// goes to the lowest index (fused_step.py:_tile_argmin), starting from
// (BIG, 0).  The dot is the policy's (sequential FMAs over the features);
// ||x||^2 is a sequential FMA over the stored values (by feature tile
// under xsq_by_tile); ||c||^2 is summed from the staged f32 tile (F32Ops)
// or read from csq.  Every thread of the
// CTA must call this (it synchronises).  On return, when n <= FT, s.xs
// still holds the whole point tile.
template <class Ops, class Load>
__device__ __forceinline__ void tile_argmin(
    TileSmemT<Ops>& s, const typename Ops::X* __restrict__ x,
    const float* __restrict__ c, int64_t m, int k, int n, int64_t r0,
    int& bidx, float& best, float& xsq, Load& xin,
    const float* __restrict__ csq = nullptr) {
  const int t = threadIdx.x;
  best = BIG;
  bidx = 0;
  xsq = 0.f;
  for (int k0 = 0; k0 < k; k0 += Ops::kt) {
    typename Ops::Acc acc;
    Ops::zero(acc);
    float c2acc = 0.f;
    for (int f0 = 0; f0 < n; f0 += FT) {
      const int fw = min(FT, n - f0);
      __syncthreads();  // earlier readers of s.xs / s.ct / s.c2 are done
      xin.load(s, x, m, n, r0, f0, fw);
      load_c_tile(s, c, k, n, k0, f0, fw);
      if constexpr (Ops::csq_given) {
        if (f0 == 0 && t < Ops::kt) s.c2[t] = k0 + t < k ? csq[k0 + t] : 0.f;
      }
      __syncthreads();
      if constexpr (!Ops::csq_given) {
        if (t < Ops::kt) {
          for (int f = 0; f < fw; ++f)
            c2acc = fmaf(s.ct.cs[t][f], s.ct.cs[t][f], c2acc);
        }
      }
      float xsq_tile = 0.f;  // xsq_by_tile: this feature tile's share
      for (int f = 0; f < fw; ++f) {
        const float xv = Ops::widen(s.xs[t][f]);
        if (k0 == 0) {
          if constexpr (Ops::xsq_by_tile) {
            xsq_tile = fmaf(xv, xv, xsq_tile);
          } else {
            xsq = fmaf(xv, xv, xsq);
          }
        }
        Ops::madd(acc, xv, s.ct, f);
      }
      if constexpr (Ops::xsq_by_tile) xsq += xsq_tile;
    }
    if constexpr (!Ops::csq_given) {
      if (t < Ops::kt) s.c2[t] = c2acc;
      __syncthreads();
    }
    const int kw = min(Ops::kt, k - k0);
#pragma unroll
    for (int j = 0; j < Ops::kt; ++j) {
      if (j < kw) {
        const float score = s.c2[j] - 2.f * Ops::dot(acc, j);
        if (score < best) {
          best = score;
          bidx = k0 + j;
        }
      }
    }
  }
}

// Deterministic sum over the CTA (fixed tree order).  All threads call it
// and all receive the sum.  `Smem` is a TileSmemT or TileSmemQ (its `red`).
template <typename Smem>
__device__ __forceinline__ float block_sum(Smem& s, float v) {
  const int t = threadIdx.x;
  s.red[t] = v;
  __syncthreads();
  for (int w = TM / 2; w > 0; w >>= 1) {
    if (t < w) s.red[t] += s.red[t + w];
    __syncthreads();
  }
  const float r = s.red[0];
  __syncthreads();
  return r;
}

// sum_i [ids_i == j] x[i, f] over the tile's rows, in row order.  Under
// bf16x3 the one-hot has no low part, so this is sum(x_hi) + sum(x_lo)
// (the reference's px.dot(onehot, x, 'bf16x3')), not the f32 sum.
template <class Ops>
__device__ __forceinline__ float onehot_sum(const TileSmemT<Ops>& s, int j,
                                            int f) {
  if constexpr (Ops::split) {
    float hi = 0.f, lo = 0.f;
    for (int i = 0; i < TM; ++i) {
      if (s.ids[i] == j) {
        float h, l;
        split_bf16(s.xs[i][f], h, l);
        hi += h;
        lo += l;
      }
    }
    return hi + lo;
  } else {
    float acc = 0.f;
    for (int i = 0; i < TM; ++i)
      acc += (s.ids[i] == j) ? Ops::widen(s.xs[i][f]) : 0.f;
    return acc;
  }
}

// One-hot contraction of one point tile into this CTA's partials:
//   P[j, f] (+)= sum_i [ids_i == j] x[i, f],   Cnt[j] (+)= sum_i [ids_i == j]
// with s.ids already set (and synchronised) by the caller.  Thread t owns
// the elements t, t + TM, ... of each (k x feature-tile) block, and sums the
// tile's rows in order, so every element has one writer and a fixed order.
// `first` stores instead of accumulating (the CTA's first tile).
// `x_resident`: s.xs already holds the whole tile (n <= FT).
template <class Ops, class Load>
__device__ __forceinline__ void tile_accumulate(
    TileSmemT<Ops>& s, const typename Ops::X* __restrict__ x, int64_t m,
    int k, int n, int64_t r0, float* P, float* Cnt, bool first,
    bool x_resident, Load& xin) {
  const int t = threadIdx.x;
  for (int f0 = 0; f0 < n; f0 += FT) {
    const int fw = min(FT, n - f0);
    if (!x_resident) {
      __syncthreads();
      xin.load(s, x, m, n, r0, f0, fw);
      __syncthreads();
    }
    const int ne = k * fw;
    for (int e = t; e < ne; e += TM) {
      const int j = e / fw;
      const int f = e - j * fw;
      const float acc = onehot_sum(s, j, f);
      float* dst = P + (int64_t)j * n + f0 + f;
      *dst = first ? acc : *dst + acc;
    }
  }
  for (int j = t; j < k; j += TM) {
    float cnt = 0.f;
    for (int i = 0; i < TM; ++i) cnt += (s.ids[i] == j) ? 1.f : 0.f;
    Cnt[j] = first ? cnt : Cnt[j] + cnt;
  }
}

// Zero a CTA's partials when it was given no tile (only when m == 0).
template <typename T>
__device__ __forceinline__ void zero_partials(T* P, int64_t stride) {
  for (int64_t e = threadIdx.x; e < stride; e += blockDim.x) P[e] = T(0);
}

// One CTA's share of the fused Lloyd step (kernels A and D, and their
// bf16 / bf16x3 twins): the partial sums [k,n], counts [k] and objective of
// the point tiles blockIdx.x, blockIdx.x + gridDim.x, ... of x [m,n]
// against c [k,n], written to P [k*n + k + 1].  Kernel D calls this with
// per-stream base pointers and the per-stream grid of kernel A, so each of
// its streams runs exactly kernel A's arithmetic in kernel A's order.
// `xin`: the slab loader (AsyncLoad for the dma kernels).
template <class Ops, class Load = SyncLoad>
__device__ __forceinline__ void fused_cta(
    TileSmemT<Ops>& s, const typename Ops::X* __restrict__ x,
    const float* __restrict__ c, float* __restrict__ P, int64_t m, int k,
    int n, int64_t num_tiles, const float* __restrict__ csq = nullptr,
    Load xin = Load()) {
  float* Cnt = P + (int64_t)k * n;
  float* Obj = Cnt + k;
  if (blockIdx.x >= num_tiles) {
    zero_partials(P, (int64_t)k * n + k + 1);
    return;
  }
  float obj = 0.f;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin(s, x, c, m, k, n, r0, bidx, best, xsq, xin, csq);
    const bool valid = r0 + threadIdx.x < m;
    s.ids[threadIdx.x] = valid ? bidx : -1;
    obj += block_sum(s, valid ? fmaxf(best + xsq, 0.f) : 0.f);
    tile_accumulate(s, x, m, k, n, r0, P, Cnt, tile == blockIdx.x, n <= FT,
                    xin);
    __syncthreads();  // s.ids / s.xs are rewritten by the next tile
  }
  xin.finish();
  if (threadIdx.x == 0) *Obj = obj;
}

// One CTA's share of the assignment as kernels B and B3 computed it on the
// CUDA cores before their redesign (assign.cu, assign_mma.cuh): ids and
// d = max(best + ||x||^2, 0) of the rows of its point tiles.  Kernel B is
// held bitwise to it under F32Ops (tests/test_torch_csrc.py).
template <class Ops>
__device__ __forceinline__ void assign_cta(
    TileSmemT<Ops>& s, const typename Ops::X* __restrict__ x,
    const float* __restrict__ c, int32_t* __restrict__ ids,
    float* __restrict__ d, int64_t m, int k, int n, int64_t num_tiles,
    const float* __restrict__ csq = nullptr) {
  SyncLoad xin;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin(s, x, c, m, k, n, r0, bidx, best, xsq, xin, csq);
    const int64_t r = r0 + threadIdx.x;
    if (r < m) {
      ids[r] = bidx;
      d[r] = fmaxf(best + xsq, 0.f);
    }
  }
}

// out[e] = sum over g = 0..G-1, in order, of part[g * stride + e] (float
// partials, or the exact int32 sums of the int8 kernels).
template <typename T>
__device__ __forceinline__ void reduce_partials(const T* __restrict__ part,
                                                T* __restrict__ out,
                                                int64_t stride, int G) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < stride;
       e += step) {
    T acc = T(0);
    for (int g = 0; g < G; ++g) acc += part[(int64_t)g * stride + e];
    out[e] = acc;
  }
}

inline int reduce_grid(int64_t stride) {
  const int64_t blocks = (stride + 255) / 256;
  return (int)(blocks < 1024 ? (blocks < 1 ? 1 : blocks) : 1024);
}

// --------------------------------------------------------------------------
// int8 bodies (assign_int8.cu, fused_step_int8.cu,
// fused_step_batched_int8.cu): the scheme of repro/kernels/precision.py.
// Inputs are the chunk's int8 codes xq [m,n] with per-feature scales
// scale [n], and the centroids' codes cq [k,n] with per-row scales t [k]
// and their full-width f32 norms csq [k] (computed from the f32 centroids
// by sqnorm_rows ahead of the kernel: the codes cannot give them).  Scores
// are
//   score_j = csq[j] - 2 * (float(sum_f xq cq_j) * t[j])
// with the integer dot exact in int32, rounded as the reference's oracle
// rounds (__fmul_rn / __fsub_rn: no FMA contraction), and
// ||x||^2 = sum_f (xq * scale[f])^2 from the dequantized codes, both norms
// summed in XlaSum's order.  Sums are the exact int32 one-hot x codes
// contraction; the wrapper scales them to f32 data space after the full
// reduce.
// --------------------------------------------------------------------------

constexpr int FTQ = 32;       // features per int8 feature tile
static_assert(FTQ == FT, "AsyncLoad tiles the int8 slabs by FT");

// A sum of n values taken one by one in index order, associated as XLA
// associates a reduction on the CPU (the plain version,
// precision.sqnorm_in_order, and the reference's norms): a reduction of
// more than 32 values becomes sums of windows of 32 over the values padded
// with zeros to a multiple of 32 (half the padding, rounded down, before
// them), each window summed in order from 0, and a reduction of the window
// sums, recursively; 32 values or fewer are summed in order from 0.  Level
// l < top holds the open window of level l; level top the final sum.  For
// n <= 32 (top = 0) it is the plain running sum.  Supports n <= 32^4.
struct XlaSum {
  static constexpr int W = 32;    // window
  static constexpr int L = 3;     // blocked levels at most
  float acc[L + 1];
  int pos[L];                     // values taken by each blocked level
  int lo[L];                      // padding before the values of each
  int top;                        // blocked levels of this n

  __device__ __forceinline__ explicit XlaSum(int n) : top(0) {
    int cnt = n;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      acc[l] = 0.f;
      pos[l] = 0;
      lo[l] = 0;
      if (cnt > W) {
        lo[l] = (-cnt & (W - 1)) / 2;
        cnt = (cnt + W - 1) / W;
        top = l + 1;
      }
    }
    acc[L] = 0.f;
  }

  // Takes v at level `from` (0: the next of the n values).
  __device__ __forceinline__ void push(float v, int from = 0) {
    bool carry = true;
#pragma unroll
    for (int l = 0; l <= L; ++l) {
      if (!carry || l < from) continue;
      if (l < top && pos[l] > 0 && (pos[l] + lo[l]) % W == 0) {
        const float done = acc[l];       // v opens a window: close this one
        acc[l] = __fadd_rn(0.f, v);
        ++pos[l];
        v = done;
      } else {
        acc[l] = __fadd_rn(acc[l], v);
        if (l < top) ++pos[l];
        carry = false;
      }
    }
  }

  // The sum, once all n values are in (the object is spent).  from: the
  // lowest level taken (1 when the caller pushed whole windows).
  __device__ __forceinline__ float finish(int from = 0) {
    float r = acc[0];
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (l >= from && l < top) push(acc[l], l + 1);  // open windows, lowest
                                                       // first
#pragma unroll
    for (int l = 1; l <= L; ++l)
      if (l == top) r = acc[l];
    return r;
  }
};

// The sum of value(f), f = b .. e-1, in order from 0 (XlaSum's order for
// 32 values or fewer).
template <class Value>
__device__ __forceinline__ float sum_in_order(int b, int e, Value value) {
  float s = 0.f;
  for (int f = b; f < e; ++f) s = __fadd_rn(s, value(f));
  return s;
}

// XlaSum of n > 32 values by the 32 lanes of a warp: lane l sums window
// base + l, lane 0 takes the window sums in order.  window(b, e) is the sum
// of values b .. e-1 in order from 0 (b < e).  Every lane of the warp calls
// it with the same n; lane 0's result is the sum.
template <class Window>
__device__ __forceinline__ float warp_xla_sum(int n, Window window) {
  const int lane = threadIdx.x & 31;
  XlaSum acc(n);
  const int windows = (n + XlaSum::W - 1) / XlaSum::W;
  for (int base = 0; base < windows; base += 32) {
    const int w0 = XlaSum::W * (base + lane) - acc.lo[0];
    const int b = w0 < 0 ? 0 : w0;
    const int e = min(w0 + XlaSum::W, n);
    const float s = b < e ? window(b, e) : 0.f;
    if (acc.top == 1) {  // 32 windows at most: their sum in order
      float total = 0.f;
#pragma unroll
      for (int src = 0; src < 32; ++src)
        if (src < windows)
          total = __fadd_rn(total, __shfl_sync(0xffffffffu, s, src));
      return total;
    }
    for (int src = 0; src < 32 && base + src < windows; ++src) {
      const float v = __shfl_sync(0xffffffffu, s, src);
      if (lane == 0) acc.push(v, 1);
    }
  }
  return acc.finish(1);
}

// The in-order sum from 0 of the squares of 32 f32 values that start on
// 16 bytes, each square rounded.
__device__ __forceinline__ float sq_window32(const float* v) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 q = reinterpret_cast<const float4*>(v)[j];
    s = __fadd_rn(s, __fmul_rn(q.x, q.x));
    s = __fadd_rn(s, __fmul_rn(q.y, q.y));
    s = __fadd_rn(s, __fmul_rn(q.z, q.z));
    s = __fadd_rn(s, __fmul_rn(q.w, q.w));
  }
  return s;
}

// Rows of one block (256 threads) of a row-sum kernel: a warp a row for
// n > 32, else a thread a row.
__host__ __device__ inline int rows_per_block(int n) {
  return n > XlaSum::W ? 256 / 32 : 256;
}
inline unsigned sqnorm_grid(int64_t rows, int n) {
  return (unsigned)((rows + rows_per_block(n) - 1) / rows_per_block(n));
}

// csq[r] = ||c_r||^2 for `rows` full-width f32 rows of n features, one
// rounding per multiply and per add, in XlaSum's order.  Blocks of 256
// threads (sqnorm_grid); the int8, bf16 and bf16x3 entry points launch it
// ahead of their kernel on the same stream.
static __global__ void sqnorm_rows(const float* __restrict__ c,
                                   float* __restrict__ csq, int64_t rows,
                                   int n) {
  const int per = rows_per_block(n);
  const int64_t r = (int64_t)blockIdx.x * per + threadIdx.x * per / 256;
  const bool live = r < rows;
  const float* row = c + (live ? r : 0) * n;
  auto sq = [&](int f) { return __fmul_rn(row[f], row[f]); };
  if (per == 256) {
    if (live) csq[r] = sum_in_order(0, n, sq);
  } else {
    const bool vec = reinterpret_cast<uintptr_t>(row) % 16 == 0;
    const float s = warp_xla_sum(n, [&](int b, int e) {  // every warp
      return vec && e - b == 32 && b % 4 == 0            // takes part
                 ? sq_window32(row + b)
                 : sum_in_order(b, e, sq);
    });
    if (live && (threadIdx.x & 31) == 0) csq[r] = s;
  }
}

struct TileSmemQ {
  int8_t xs[TM][FTQ + 4];  // point codes; a 36-byte row stride (9 words,
                           // odd) keeps a warp's column reads on 32 banks
  int8_t cs[KT][FTQ];      // centroid codes (broadcast reads)
  float sc[FTQ];           // chunk scales of the feature tile
  float c2[KT];            // full-width ||c||^2 of the k tile
  float t[KT];             // centroid row scales of the k tile
  int ids[TM];             // tile assignment; -1 never matches a cluster
  float red[TM];           // block-reduction scratch (block_sum)
};

// Stage cq[k0 : k0+KT, f0 : f0+fw] into s.cs and the feature tile's scales
// into s.sc; entries past k or fw read as 0.
__device__ __forceinline__ void load_cq_tile(TileSmemQ& s,
                                             const int8_t* __restrict__ c,
                                             const float* __restrict__ scale,
                                             int k, int n, int k0, int f0,
                                             int fw) {
  for (int q = threadIdx.x; q < KT * FTQ; q += TM) {
    const int j = q / FTQ;
    const int col = q - j * FTQ;
    s.cs[j][col] = (k0 + j < k && col < fw)
                       ? c[(int64_t)(k0 + j) * n + f0 + col]
                       : (int8_t)0;
  }
  if (threadIdx.x < FTQ)
    s.sc[threadIdx.x] = (int)threadIdx.x < fw ? scale[f0 + threadIdx.x] : 0.f;
}

// Nearest centroid of row r0 + threadIdx.x under the int8 scheme: the
// running (min, argmin) of score_j over all k with a strict '<' (ties go to
// the lowest index, fused_step.py:_tile_argmin), from (BIG, 0), and the
// dequantized ||x||^2 (its squares in XlaSum's order).  Every thread of the
// CTA must call this.  On return, when n <= FTQ, s.xs still holds the whole
// point tile.  `xin` loads the code slabs (load_x_tile on the TileSmemQ).
template <class Load>
__device__ __forceinline__ void tile_argmin_q(
    TileSmemQ& s, const int8_t* __restrict__ x, const int8_t* __restrict__ c,
    const float* __restrict__ csq, const float* __restrict__ tq,
    const float* __restrict__ scale, int64_t m, int k, int n, int64_t r0,
    int& bidx, float& best, float& xsq, Load& xin) {
  const int t = threadIdx.x;
  best = BIG;
  bidx = 0;
  XlaSum xsq_acc(n);
  for (int k0 = 0; k0 < k; k0 += KT) {
    int acc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[j] = 0;
    for (int f0 = 0; f0 < n; f0 += FTQ) {
      const int fw = min(FTQ, n - f0);
      __syncthreads();  // earlier readers of s.xs / s.cs / s.c2 / s.t done
      xin.load(s, x, m, n, r0, f0, fw);
      load_cq_tile(s, c, scale, k, n, k0, f0, fw);
      if (f0 == 0 && t < KT) {
        s.c2[t] = k0 + t < k ? csq[k0 + t] : 0.f;
        s.t[t] = k0 + t < k ? tq[k0 + t] : 0.f;
      }
      __syncthreads();
      for (int f = 0; f < fw; ++f) {
        const int xv = s.xs[t][f];
        if (k0 == 0) {
          const float dq = __fmul_rn((float)xv, s.sc[f]);
          xsq_acc.push(__fmul_rn(dq, dq));
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) acc[j] += xv * (int)s.cs[j][f];
      }
    }
    if (k0 == 0) xsq = xsq_acc.finish();
    const int kw = min(KT, k - k0);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < kw) {
        const float d = __fmul_rn((float)acc[j], s.t[j]);
        const float score = __fsub_rn(s.c2[j], 2.f * d);
        if (score < best) {
          best = score;
          bidx = k0 + j;
        }
      }
    }
  }
}

// int8 one-hot contraction of one point tile into this CTA's partials:
//   P[j, f] (+)= sum_i [ids_i == j] xq[i, f]   (exact int32)
//   Cnt[j]  (+)= sum_i [ids_i == j]            (f32)
// with the ownership and order of tile_accumulate.  `x_resident`: s.xs
// already holds the whole tile (n <= FTQ).
template <class Load>
__device__ __forceinline__ void tile_accumulate_q(
    TileSmemQ& s, const int8_t* __restrict__ x, int64_t m, int k, int n,
    int64_t r0, int32_t* P, float* Cnt, bool first, bool x_resident,
    Load& xin) {
  const int t = threadIdx.x;
  for (int f0 = 0; f0 < n; f0 += FTQ) {
    const int fw = min(FTQ, n - f0);
    if (!x_resident) {
      __syncthreads();
      xin.load(s, x, m, n, r0, f0, fw);
      __syncthreads();
    }
    const int ne = k * fw;
    for (int e = t; e < ne; e += TM) {
      const int j = e / fw;
      const int f = e - j * fw;
      int32_t acc = 0;
      for (int i = 0; i < TM; ++i) acc += (s.ids[i] == j) ? (int)s.xs[i][f] : 0;
      int32_t* dst = P + (int64_t)j * n + f0 + f;
      *dst = first ? acc : *dst + acc;
    }
  }
  for (int j = t; j < k; j += TM) {
    float cnt = 0.f;
    for (int i = 0; i < TM; ++i) cnt += (s.ids[i] == j) ? 1.f : 0.f;
    Cnt[j] = first ? cnt : Cnt[j] + cnt;
  }
}

// One CTA's share of the int8 fused Lloyd step (kernels A8 and D8): the
// partial int32 sums P [k*n] and the f32 counts and objective F [k + 1] of
// the point tiles blockIdx.x, blockIdx.x + gridDim.x, ...  Kernel D8 calls
// this with per-stream base pointers and kernel A8's per-stream grid, so
// each of its streams runs kernel A8's arithmetic in kernel A8's order.
// `xin`: the slab loader (AsyncLoad for A8-dma).
template <class Load = SyncLoad>
__device__ __forceinline__ void fused_cta_q(
    TileSmemQ& s, const int8_t* __restrict__ x, const int8_t* __restrict__ c,
    const float* __restrict__ csq, const float* __restrict__ tq,
    const float* __restrict__ scale, int32_t* __restrict__ P,
    float* __restrict__ F, int64_t m, int k, int n, int64_t num_tiles,
    Load xin = Load()) {
  float* Cnt = F;
  float* Obj = F + k;
  if (blockIdx.x >= num_tiles) {
    zero_partials(P, (int64_t)k * n);
    zero_partials(F, (int64_t)k + 1);
    return;
  }
  float obj = 0.f;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin_q(s, x, c, csq, tq, scale, m, k, n, r0, bidx, best, xsq,
                  xin);
    const bool valid = r0 + threadIdx.x < m;
    s.ids[threadIdx.x] = valid ? bidx : -1;
    obj += block_sum(s, valid ? fmaxf(best + xsq, 0.f) : 0.f);
    tile_accumulate_q(s, x, m, k, n, r0, P, Cnt, tile == blockIdx.x,
                      n <= FTQ, xin);
    __syncthreads();  // s.ids / s.xs are rewritten by the next tile
  }
  xin.finish();
  if (threadIdx.x == 0) *Obj = obj;
}

}  // namespace repro
