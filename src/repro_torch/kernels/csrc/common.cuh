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
// sorted scatter of a tile into the partials, the ordered reductions — is
// one code path.
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
// CTAs an SM that the f32 and bf16 fused kernels are compiled for
// (__launch_bounds__: 64 registers a thread), so that kernel D's many CTAs
// fill each SM four deep.
constexpr int FUSED_MIN_CTAS = 4;

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
// Sum policies: the element type X of x, the type S of a sum, and one
// thread's running sum of a run of rows' values, from +0 in row order.  The
// fused bodies and the update kernels (update.cuh) sum with them.
// --------------------------------------------------------------------------

// f32 values, f32 sums.
struct SumF32 {
  using X = float;
  using S = float;
  float a = 0.f;
  __device__ __forceinline__ void add(float v) { a += v; }
  __device__ __forceinline__ float get() const { return a; }
};

// bf16 values, f32 sums.
struct SumBf16 {
  using X = __nv_bfloat16;
  using S = float;
  float a = 0.f;
  __device__ __forceinline__ void add(__nv_bfloat16 v) {
    a += __bfloat162float(v);
  }
  __device__ __forceinline__ float get() const { return a; }
};

// bf16x3: f32 values split into bf16 hi + lo, the two summed apart and
// added at the end of the run (the reference's px.dot(onehot, x, 'bf16x3'):
// the one-hot has no low part).
struct SumBf16x3 {
  using X = float;
  using S = float;
  float hi = 0.f, lo = 0.f;
  __device__ __forceinline__ void add(float v) {
    float h, l;
    split_bf16(v, h, l);
    hi += h;
    lo += l;
  }
  __device__ __forceinline__ float get() const { return hi + lo; }
};

// int8 codes, exact int32 sums.
struct SumInt8 {
  using X = int8_t;
  using S = int32_t;
  int32_t a = 0;
  __device__ __forceinline__ void add(int8_t v) { a += (int32_t)v; }
  __device__ __forceinline__ int32_t get() const { return a; }
};

// --------------------------------------------------------------------------
// A point tile's rows grouped by cluster.  Thread t writes the key of row t,
// run_key(id): (id, row), with ABSENT for a row that joins no cluster (past
// m, or an id outside [0, k)).  find_runs orders the rows as the sorted
// keys do (by counting where k is small), so that each cluster present in
// the tile is one run of rows in ascending row order and the absent rows
// come last, and lists the runs in order of cluster.
//
// Summing a run's rows in row order from +0 is bitwise the one-hot sum the
// kernels took before (ids_i == j ? x_i : +0 over all TM rows, from +0):
// skipping a +0 term is exact.  A sum that starts at +0 under round to
// nearest is never -0 (x + y is -0 only when both are -0), and s + (+0) == s
// for every s that is not -0 (infinities included; a NaN stays a NaN).  For
// the same reason a cluster absent from a tile may be skipped where the
// one-hot added +0 to it.
// --------------------------------------------------------------------------

constexpr int WARPS = TM / 32;
constexpr unsigned ABSENT = 0xFFFFFFFFu;  // the id half of an absent key

constexpr int COUNT_K = 32;  // clusters up to which find_runs counts

struct TileRuns {
  unsigned long long key[TM];     // (id, row), sorted in place (k > COUNT_K)
  int row[TM];                    // row of sorted position p
  int wsum[WARPS];                // run starts per warp
  int start[TM + 1];              // first position of run q; [runs] = end
  int rid[TM];                    // cluster of run q (ascending)
  int runs;
  int cnt[WARPS][COUNT_K];        // k <= COUNT_K: rows of cluster j in
                                  // warp w
};

// The key of this thread's row (row threadIdx.x of the tile) in cluster id.
__device__ __forceinline__ unsigned long long run_key(unsigned id) {
  return ((unsigned long long)id << 32) | (unsigned)threadIdx.x;
}

// v of lane (lane ^ mask) of the warp.
__device__ __forceinline__ unsigned long long shfl_xor_u64(
    unsigned long long v, int mask) {
  const unsigned lo = __shfl_xor_sync(0xffffffffu, (unsigned)v, mask);
  const unsigned hi = __shfl_xor_sync(0xffffffffu, (unsigned)(v >> 32), mask);
  return ((unsigned long long)hi << 32) | lo;
}

// Bitonic sort of the TM keys, ascending.  The keys are distinct (the row
// is in the low half), so the order is the stable one.  Thread t holds
// position t: it swaps with t ^ stride through a shuffle within its warp
// (stride < 32), else through `key`, keeping the smaller key where its
// pair's order (ascending in blocks of `size` whose bit t & size is 0)
// puts it first.  Every thread calls it; it synchronises before and after.
__device__ __forceinline__ void sort_keys(unsigned long long* key) {
  const int t = threadIdx.x;
  __syncthreads();
  unsigned long long v = key[t];
  for (int size = 2; size <= TM; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long other;
      if (stride >= 32) {
        key[t] = v;
        __syncthreads();
        other = key[t ^ stride];
        __syncthreads();
      } else {
        other = shfl_xor_u64(v, stride);
      }
      const bool first = ((t & stride) == 0) == ((t & size) == 0);
      v = (first == (v < other)) ? v : other;
    }
  }
  key[t] = v;
  __syncthreads();
}

// The run table of a tile of k <= COUNT_K clusters, by counting: a row's
// position is its cluster's first position, plus the cluster's rows in
// earlier warps, plus its rank among the lanes of its warp in that cluster
// (__match_any_sync), so each run holds its rows in row order, as the sort
// puts them.  Lane j of each warp takes cluster j's count and, by a scan
// over the lanes, its first position.
__device__ __forceinline__ void count_runs(TileRuns& r) {
  const int t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  const unsigned id = (unsigned)(r.key[t] >> 32);
  const bool present = id != ABSENT;
  r.cnt[w][lane] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (present && rank == 0) r.cnt[w][id] = __popc(peers);
  __syncthreads();
  int rows = 0;  // of cluster `lane`
  for (int v = 0; v < WARPS; ++v) rows += r.cnt[v][lane];
  int upto = rows;  // of the clusters up to `lane`
  for (int d = 1; d < 32; d <<= 1) {
    const int below = __shfl_up_sync(0xffffffffu, upto, d);
    if (lane >= d) upto += below;
  }
  const int first = upto - rows;
  const unsigned runs = __ballot_sync(0xffffffffu, rows > 0);
  const int mine = __shfl_sync(0xffffffffu, first, present ? (int)id : 0);
  if (present) {
    int pos = mine + rank;
    for (int v = 0; v < w; ++v) pos += r.cnt[v][id];
    r.row[pos] = t;
  }
  if (w == 0) {
    if (rows > 0) {
      const int q = __popc(runs & ((1u << lane) - 1u));
      r.start[q] = first;
      r.rid[q] = lane;
    }
    if (lane == 31) {
      r.runs = __popc(runs);
      r.start[__popc(runs)] = upto;
    }
  }
  __syncthreads();
}

// Fills the run table of the tile's keys r.key: run q holds the sorted
// positions start[q] .. start[q+1] - 1 (rows row[p]) of cluster rid[q],
// q < runs, in ascending order of cluster.  Up to COUNT_K clusters by
// counting (count_runs), else by sorting the keys: then the run starts up
// to t (in the warp, then in earlier warps) give each run its index.  Every
// thread calls it, after writing its key; it synchronises before and after.
__device__ __forceinline__ void find_runs(TileRuns& r, int k) {
  if (k <= COUNT_K) {
    __syncthreads();
    count_runs(r);
    return;
  }
  const int t = threadIdx.x;
  const int lane = t & 31;
  sort_keys(r.key);
  const unsigned long long key = r.key[t];
  const unsigned kid = (unsigned)(key >> 32);
  const bool present = kid != ABSENT;
  const bool lead =
      present && (t == 0 || (unsigned)(r.key[t - 1] >> 32) != kid);
  const bool last =
      present && (t == TM - 1 || (unsigned)(r.key[t + 1] >> 32) != kid);
  r.row[t] = (int)(key & 0xFFFFFFFFu);
  const unsigned leads = __ballot_sync(0xffffffffu, lead);
  int v = __popc(leads & (0xffffffffu >> (31 - lane)));
  if (lane == 31) r.wsum[t >> 5] = v;
  __syncthreads();
  for (int w = 0; w < (t >> 5); ++w) v += r.wsum[w];
  if (lead) {
    r.start[v - 1] = t;
    r.rid[v - 1] = (int)kid;
  }
  // the last present row ends the last run; no present row, no run
  if (last && (t == TM - 1 || (unsigned)(r.key[t + 1] >> 32) == ABSENT)) {
    r.start[v] = t + 1;
    r.runs = v;
  }
  if (t == 0 && !present) r.runs = 0;
  __syncthreads();
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
//   widen       a stored x element as f32;
//   Sum         the sum of a run of stored x elements (the partial sums').
// --------------------------------------------------------------------------

// Kernels A-D: true fp32, sequential FMAs over the features.
struct F32Ops {
  using X = float;
  static constexpr int kt = KT;
  static constexpr int xpad = 1;
  static constexpr bool csq_given = false;
  static constexpr bool xsq_by_tile = false;
  static constexpr bool split = false;
  using Sum = SumF32;  // a run's sum of stored values
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
  using Sum = SumBf16;  // a run's sum of stored values
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
  using Sum = SumBf16x3;  // a run's sum of stored values
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
  int ids[TM];    // tile assignment (the one-hot body, onehot.cuh)
  float red[TM];  // block-reduction scratch
  TileRuns runs;  // the tile's rows grouped by cluster
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
//            stays in s.xs across the k loop and the sorted scatter, so
//            later loads of the same tile return at once;
//   n >  FT: tile_argmin's (k tile, feature tile) slabs, then
//            tile_scatter's feature tiles: nf * (k tiles + 1) slabs, the
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

// Zero a CTA's partials (at its start; and when it was given no tile, only
// when m == 0, its objective too).
template <typename T>
__device__ __forceinline__ void zero_partials(T* P, int64_t stride) {
  for (int64_t e = threadIdx.x; e < stride; e += blockDim.x) P[e] = T(0);
}

// The sorted scatter of one point tile into this CTA's partials:
//   P[j, f] (+)= the run of cluster j's rows, summed in row order from +0,
//   Cnt[j]  (+)= the run's length,
// for each cluster j present in the tile (s.runs, set by find_runs);
// `first` (the CTA's first tile) stores instead of adding, into partials
// the caller zeroed, so that a cluster absent from the tile keeps its +0.
// That is bitwise the one-hot contraction (see TileRuns).  Per feature
// tile, a group of L threads (the least power of two >= fw) takes a run, a
// thread a feature: each (run, feature) element has one writer and a fixed
// order, and a run is never split.  `S` is a TileSmemT or TileSmemQ;
// `x_resident`: s.xs already holds the whole tile (n <= FT), else each
// feature tile is loaded in turn (xin, in kernel A's slab order).
template <class Sum, class S, class Load>
__device__ __forceinline__ void tile_scatter(
    S& s, const typename Sum::X* __restrict__ x, int64_t m, int n,
    int64_t r0, typename Sum::S* P, float* Cnt, bool first, bool x_resident,
    Load& xin) {
  const int t = threadIdx.x;
  const TileRuns& r = s.runs;
  const int runs = r.runs;
  for (int f0 = 0; f0 < n; f0 += FT) {
    const int fw = min(FT, n - f0);
    if (!x_resident) {
      __syncthreads();
      xin.load(s, x, m, n, r0, f0, fw);
      __syncthreads();
    }
    int lanes = 1;
    while (lanes < fw) lanes <<= 1;
    const int f = t & (lanes - 1);
    if (f < fw) {
      for (int q = t / lanes; q < runs; q += TM / lanes) {
        typename Sum::S* dst = P + (int64_t)r.rid[q] * n + f0 + f;
        const typename Sum::S before = first ? 0 : *dst;
        Sum acc;
        for (int p = r.start[q]; p < r.start[q + 1]; ++p)
          acc.add(s.xs[r.row[p]][f]);
        *dst = first ? acc.get() : before + acc.get();
      }
    }
  }
  for (int q = t; q < runs; q += TM) {
    const float len = (float)(r.start[q + 1] - r.start[q]);
    Cnt[r.rid[q]] = first ? len : Cnt[r.rid[q]] + len;
  }
}

// One CTA's share of the fused Lloyd step (kernels A and D, and their
// bf16 / bf16x3 twins): the partial sums [k,n], counts [k] and objective of
// the point tiles blockIdx.x, blockIdx.x + gridDim.x, ... of x [m,n]
// against c [k,n], written to P [k*n + k + 1].  Per tile: the argmin of
// each row (tile_argmin), the objective's block sum, the tile's rows sorted
// into runs of one cluster (find_runs) and their sorted scatter into the
// partials (tile_scatter).  Kernel D calls this with per-stream base
// pointers and the per-stream grid of kernel A, so each of its streams runs
// exactly kernel A's arithmetic in kernel A's order.
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
  zero_partials(P, (int64_t)k * n + k);  // absent clusters' +0; ordered
                                         // by tile_argmin's barriers
  float obj = 0.f;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin(s, x, c, m, k, n, r0, bidx, best, xsq, xin, csq);
    const bool valid = r0 + threadIdx.x < m;
    s.runs.key[threadIdx.x] = run_key(valid ? (unsigned)bidx : ABSENT);
    obj += block_sum(s, valid ? fmaxf(best + xsq, 0.f) : 0.f);
    find_runs(s.runs, k);
    tile_scatter<typename Ops::Sum>(s, x, m, n, r0, P, Cnt,
                                    tile == blockIdx.x, n <= FT, xin);
    __syncthreads();  // s.runs / s.xs are rewritten by the next tile
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
// summed in XlaSum's order.  Sums are the exact int32 per-cluster sums of
// the codes; the wrapper scales them to f32 data space after the full
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
  int ids[TM];             // tile assignment (the one-hot body)
  float red[TM];           // block-reduction scratch (block_sum)
  TileRuns runs;           // the tile's rows grouped by cluster
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

// One CTA's share of the int8 fused Lloyd step (kernels A8 and D8): the
// partial int32 sums P [k*n] and the f32 counts and objective F [k + 1] of
// the point tiles blockIdx.x, blockIdx.x + gridDim.x, ..., the float body's
// phases on the codes (tile_argmin_q; the exact int32 sums of SumInt8).
// Kernel D8 calls this with per-stream base pointers and kernel A8's
// per-stream grid, so each of its streams runs kernel A8's arithmetic in
// kernel A8's order.  `xin`: the slab loader (AsyncLoad for A8-dma).
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
  zero_partials(P, (int64_t)k * n);  // absent clusters' +0; ordered by
  zero_partials(F, (int64_t)k);      // tile_argmin_q's barriers
  float obj = 0.f;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin_q(s, x, c, csq, tq, scale, m, k, n, r0, bidx, best, xsq,
                  xin);
    const bool valid = r0 + threadIdx.x < m;
    s.runs.key[threadIdx.x] = run_key(valid ? (unsigned)bidx : ABSENT);
    obj += block_sum(s, valid ? fmaxf(best + xsq, 0.f) : 0.f);
    find_runs(s.runs, k);
    tile_scatter<SumInt8>(s, x, m, n, r0, P, Cnt, tile == blockIdx.x,
                          n <= FTQ, xin);
    __syncthreads();  // s.runs / s.xs are rewritten by the next tile
  }
  xin.finish();
  if (threadIdx.x == 0) *Obj = obj;
}

}  // namespace repro
