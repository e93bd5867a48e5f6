// Kernel P: kpp_probe — the K-means++ candidate probe in one pass.
//
// Replaces the Pallas kernel repro/kernels/kpp_probe.py:kpp_probe_pallas
// (_kpp_kernel).  For points x [m,n] f32, L candidate seeds cands [L,n] f32
// and the current distances d [m] f32 it returns
//   newd [m,L] = min(d, max((||c_l||^2 - 2 x.c_l) + ||x||^2, 0))
//   pot [L]    = sum over the m rows of newd[:, l]
// with ||x||^2, ||c_l||^2 and x.c_l sequential f32 FMAs over the features,
// associated as the plain version (kpp_probe.py:kpp_probe_plain).  A row's
// newd depends on nothing but that order, so it is the same whatever grid
// or candidate tile computes it.
//
// Bound: bytes.  It reads x and d once and writes newd once: at one slot's
// probe of a full HEPMASS seeding (m = 10.5M, n = 28, L = 3) 1.34 GB,
// 401 us at 3.35 TB/s, against 2mLn = 1.8 GFLOP.  The design keeps x's
// next tiles in flight while a tile computes:
//   * Persistent CTAs of TM threads walk point tiles of TM rows, thread t
//     owning row t; as many CTAs as the SMs hold (2 an SM at n = 28).
//   * For n <= FT (every HEPMASS and Big-means chunk seeding) a point tile
//     is one contiguous span of x, and one of d: one thread copies both
//     with Hopper's 1-D bulk copy (cp.async.bulk) into a ring of
//     STAGES_RES stages, each completing on its mbarrier, so two tiles are
//     in flight while one computes.  A span is copied from the 16-byte
//     boundary at or below its start to the one at or above its end, so
//     any 4-byte-aligned base works; the extra words lie in the same 16
//     bytes as a word of x or d (so in its page) and are never used.
//   * For n > FT each (point tile, candidate tile, feature tile) slab is
//     TM row segments, strided: the CTA's threads copy it with cp.async (16
//     bytes a copy where x is 16-byte aligned and n a multiple of 4, else
//     4), the candidate slab beside it, into a ring of STAGES_TILED stages
//     retired by wait_group.  (One bulk copy a row segment, or one 2-D
//     tensor-map copy a slab, was no faster on the H100.)
//   * The candidate tile CT follows L (4, 8 or 32 dots in registers a
//     row); L > CT loops over candidate tiles.  For n <= FT the candidates
//     are staged once per CTA, transposed [n][CT] so that one 16-byte
//     broadcast read gives four candidates' feature.
//   * A tile's newd block goes through shared memory and out with
//     coalesced stores (16-byte stores when the block [rows, L] is one
//     dense span).  The potentials are summed in registers across the
//     CTA's tiles (L <= CT; else each tile's column sums, a fixed tree, in
//     shared memory), reduced over the CTA by a fixed tree, and written as
//     the CTA's partials.
//   * One launch, no float atomics: the last CTA to finish, found by an
//     integer ticket (atomicAdd after __threadfence), adds the partials in
//     a fixed order (contiguous runs of CTAs in CTA order, then the runs by
//     a tree).  The caller hands the launch a ticket at zero that no
//     launch in flight on another stream uses (kpp_probe_cuda allocates
//     one with the launch's partials and zeroes it on the stream, a memset
//     node when captured into a graph); the last CTA leaves it at zero.
//     Repeated launches are bitwise equal.
#include "common.cuh"

namespace repro {
namespace {

constexpr int STAGES_RES = 3;    // ring stages for n <= FT (a point tile each)
constexpr int STAGES_TILED = 4;  // ring stages for n > FT (a slab each)
// Floats a staged row segment of FT features takes for n > FT: nine
// 16-byte chunks for 16-byte copies and reads (XS), FT + 1 words for 4-byte
// ones; either count odd, so that a warp's rows are free of bank
// conflicts.
constexpr int XS = FT + 4;
__host__ __device__ constexpr int row_floats(int vw) {
  return vw == 4 ? XS : FT + 1;
}

// The bulk-copy primitives: an mbarrier in shared memory (init, arrive
// with an expected byte count, wait for a phase by its parity),
// cp.async.bulk global -> shared completing on an mbarrier, and the fence
// that orders this thread's generic accesses of shared memory before a
// later bulk copy into it.  (The host stand-in of the kernel tests defines
// REPRO_HOST_BULK_COPY and its own: a copy lands when a wait finds its
// phase complete.)
#ifndef REPRO_HOST_BULK_COPY
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
#endif
#ifndef REPRO_HOST_ASYNC_COPY
// An asynchronous 16-byte copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
#endif

// [a0, a1): the 16-byte-aligned span covering `bytes` bytes at p.
struct Span {
  uintptr_t a0, a1;
  __device__ __forceinline__ Span(const void* p, int64_t bytes) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    a0 = a & ~(uintptr_t)15;
    a1 = (a + (uintptr_t)bytes + 15) & ~(uintptr_t)15;
  }
  __device__ __forceinline__ unsigned bytes() const {
    return (unsigned)(a1 - a0);
  }
  __device__ __forceinline__ const void* src() const {
    return reinterpret_cast<const void*>(a0);
  }
};

struct KppArgs {
  const float* x;
  const float* cands;
  const float* d;
  float* newd;
  float* part;  // [grid, L] per-CTA partial potentials
  float* pot;
  int* ticket;  // the launch's own, zeroed before it
  int64_t m;
  int L;
  int n;
  int64_t num_tiles;
};

// Dynamic shared memory of a launch (byte offsets, each a multiple of 16).
struct KppLayout {
  int x_bytes;      // a stage's x slab
  int stage_bytes;  // x slab, then the d span (n <= FT) or the candidate
                    // slab [FT][CT] (n > FT)
  int cands;        // n <= FT: candidates [ceil(L / CT)][n][CT]
  int c2;           // ||c||^2, [ceil(L / CT) * CT] (n > FT: [CT])
  int nd;           // a tile's newd block, [TM][(lw | 1)]
  int red;          // [TM] partials' reduce
  int psum;         // [ceil(L / CT) * CT] the CTA's potentials (L > CT)
  int bars;         // [stages] mbarriers (n <= FT)
  int flag;         // the last-CTA flag
  int total;
};

__host__ __device__ inline KppLayout kpp_layout(int n, int L, int ct) {
  KppLayout o{};
  const int lp = (L + ct - 1) / ct * ct;
  const bool tiled = n > FT;
  const int stages = tiled ? STAGES_TILED : STAGES_RES;
  o.x_bytes = tiled ? TM * XS * 4 : TM * n * 4 + 16;
  o.stage_bytes = o.x_bytes + (tiled ? FT * ct * 4 : TM * 4 + 16);
  int off = stages * o.stage_bytes;
  o.cands = off;
  off += tiled ? 0 : lp * n * 4;
  o.c2 = off;
  off += lp * 4;
  o.nd = off;
  off += TM * (ct + 1) * 4;
  o.red = off;
  off += TM * 4;
  o.psum = off;
  off += lp * 4;
  o.bars = off;
  off += (stages * 8 + 15) / 16 * 16;
  o.flag = off;
  off += 16;
  o.total = off;
  return o;
}

// acc[j] (+)= x . c_j over this thread's row segment xr [nf features] and
// the candidate slab cT [nf][CT]; ||x||^2 too when `first` (the first
// candidate tile).  Sequential FMAs in feature order.  VW: floats a read of
// xr (4: xr 16-byte aligned and nf a multiple of 4).
template <int CT, int VW>
__device__ __forceinline__ void row_dots(const float* xr, const float* cT,
                                         int nf, float& xsq,
                                         float (&acc)[CT], bool first) {
#pragma unroll 2
  for (int f = 0; f < nf; f += VW) {
    float xv[VW];
    if constexpr (VW == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + f);
      xv[0] = v.x;
      xv[1] = v.y;
      xv[2] = v.z;
      xv[3] = v.w;
    } else {
      xv[0] = xr[f];
    }
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float xe = xv[e];
      if (first) xsq = fmaf(xe, xe, xsq);
      const float4* c4 = reinterpret_cast<const float4*>(cT + (f + e) * CT);
#pragma unroll
      for (int q = 0; q < CT / 4; ++q) {
        const float4 c = c4[q];
        acc[4 * q] = fmaf(xe, c.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(xe, c.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xe, c.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xe, c.w, acc[4 * q + 3]);
      }
    }
  }
}

// acc (+)= v[f * stride]^2 for f < nf, sequential FMAs in order (the loads
// eight at a time ahead of their FMAs).
__device__ __forceinline__ float sq_chain(const float* v, int stride, int nf,
                                          float acc) {
  int f = 0;
  for (; f + 8 <= nf; f += 8) {
    float u[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) u[e] = v[(f + e) * stride];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(u[e], u[e], acc);
  }
  for (; f < nf; ++f) acc = fmaf(v[f * stride], v[f * stride], acc);
  return acc;
}

// nd[row][j] (row stride s) summed over the TM rows into row 0, a fixed
// tree: rows r and r + w for w = TM/2, ..., 1.  Every thread calls it.
__device__ __forceinline__ void column_tree(float* nd, int lw, int s) {
  for (int w = TM / 2; w > 0; w >>= 1) {
    for (int q = threadIdx.x; q < w * lw; q += TM) {
      const int row = q / lw;
      const int j = q - row * lw;
      nd[row * s + j] += nd[(row + w) * s + j];
    }
    __syncthreads();
  }
}

// Candidate tile l0 of this thread's row, its dots done: newd into the
// tile's block (through nd, out with coalesced stores) and the potentials
// (pacc in registers when L <= CT, else the tile's column sums into psum).
// c2: the tile's ||c||^2.  Every thread calls it.
template <int CT>
__device__ __forceinline__ void tile_epilogue(
    const KppArgs& a, float* nd, float* psum, const float* c2, int l0,
    int64_t r0, int rows, float dr, float xsq, const float (&acc)[CT],
    float (&pacc)[CT], bool first_tile) {
  const int t = threadIdx.x;
  const int L = a.L;
  const int lw = min(CT, L - l0);
  const int s = lw | 1;
  const bool one = L <= CT;
  const bool valid = t < rows;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    if (j < lw) {
      const float v = fminf(dr, fmaxf((c2[j] - 2.f * acc[j]) + xsq, 0.f));
      if (one && valid) pacc[j] += v;
      nd[t * s + j] = valid ? v : 0.f;
    }
  }
  __syncthreads();
  float* dst = a.newd + r0 * L + l0;
  if (lw == L && s == lw) {  // the block is one dense span of rows * L
    const int count = rows * L;
    const int vec =
        (reinterpret_cast<uintptr_t>(dst) & 15) == 0 ? count / 4 : 0;
    for (int q = t; q < vec; q += TM)
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(nd)[q];
    for (int q = 4 * vec + t; q < count; q += TM) dst[q] = nd[q];
  } else {
    for (int q = t; q < rows * lw; q += TM) {
      const int row = q / lw;
      const int j = q - row * lw;
      dst[(int64_t)row * L + j] = nd[row * s + j];
    }
  }
  if (!one) {
    __syncthreads();  // nd is read out before the tree rewrites it
    column_tree(nd, lw, s);
    if (t < lw) psum[l0 + t] = first_tile ? nd[t] : psum[l0 + t] + nd[t];
    __syncthreads();  // nd[0..lw) is read before the next tile writes it
  }
}

// n <= FT, thread 0: the CTA's point tile i (x and d) into stage i %
// STAGES_RES.
__device__ __forceinline__ void issue_tile(const KppArgs& a,
                                           const KppLayout& lay,
                                           unsigned char* smem, int64_t i) {
  const int64_t r0 = ((int64_t)blockIdx.x + i * gridDim.x) * TM;
  const int64_t rows = a.m - r0 < TM ? a.m - r0 : TM;
  unsigned char* st = smem + (int)(i % STAGES_RES) * lay.stage_bytes;
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + lay.bars) + i % STAGES_RES;
  const Span xs(a.x + r0 * a.n, rows * a.n * 4), ds(a.d + r0, rows * 4);
  mbar_arrive_tx(bar, xs.bytes() + ds.bytes());
  bulk_load(st, xs.src(), xs.bytes(), bar);
  bulk_load(st + lay.x_bytes, ds.src(), ds.bytes(), bar);
}

// n <= FT: a point tile a stage, candidates staged once.
template <int CT, int VW>
__device__ __forceinline__ void resident_body(const KppArgs& a,
                                              const KppLayout& lay,
                                              unsigned char* smem,
                                              int64_t my_tiles,
                                              float (&pacc)[CT]) {
  const int t = threadIdx.x;
  const int L = a.L, n = a.n;
  const int nct = (L + CT - 1) / CT;
  const int S = STAGES_RES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  float* cT = reinterpret_cast<float*>(smem + lay.cands);
  float* c2s = reinterpret_cast<float*>(smem + lay.c2);
  float* nd = reinterpret_cast<float*>(smem + lay.nd);
  float* psum = reinterpret_cast<float*>(smem + lay.psum);
  // every tile's x and d spans start at the same offset within 16 bytes
  // (a tile's x is TM * n * 4 bytes, a multiple of 16)
  const int xoff = (int)(reinterpret_cast<uintptr_t>(a.x) & 15) / 4;
  const int doff = (int)(reinterpret_cast<uintptr_t>(a.d) & 15) / 4;
  if (t == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0)
    for (int64_t i = 0; i < S - 1 && i < my_tiles; ++i)
      issue_tile(a, lay, smem, i);
  // candidates [nct][n][CT], zero past L, and their norms
  for (int q = t; q < nct * CT * n; q += TM) {
    const int l = q / n;
    const int f = q - l * n;
    const int ct = l / CT;
    cT[(ct * n + f) * CT + (l - ct * CT)] =
        l < L ? a.cands[(int64_t)l * n + f] : 0.f;
  }
  __syncthreads();
  for (int l = t; l < nct * CT; l += TM) {
    c2s[l] = sq_chain(cT + (l / CT) * n * CT + l % CT, CT, n, 0.f);
  }
  for (int64_t i = 0; i < my_tiles; ++i) {
    __syncthreads();  // stage (i - 1) % S and nd are read; cands staged
    if (t == 0 && i + S - 1 < my_tiles) {
      async_proxy_fence();
      issue_tile(a, lay, smem, i + S - 1);
    }
    const int s = (int)(i % S);
    mbar_wait(&bars[s], (unsigned)((i / S) & 1));
    const unsigned char* st = smem + s * lay.stage_bytes;
    const int64_t r0 = ((int64_t)blockIdx.x + i * gridDim.x) * TM;
    const int rows = (int)(a.m - r0 < TM ? a.m - r0 : TM);
    const float* xr = reinterpret_cast<const float*>(st) + xoff + t * n;
    const float dr =
        reinterpret_cast<const float*>(st + lay.x_bytes)[doff + t];
    float xsq = 0.f;
    for (int ct = 0; ct < nct; ++ct) {
      float acc[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[j] = 0.f;
      row_dots<CT, VW>(xr, cT + ct * n * CT, n, xsq, acc, ct == 0);
      tile_epilogue<CT>(a, nd, psum, c2s + ct * CT, ct * CT, r0, rows, dr,
                        xsq, acc, pacc, i == 0);
    }
  }
}

// A slab of the n > FT walk: (the CTA's point tile, candidate tile,
// feature tile), feature tiles fastest.
struct Slab {
  int64_t ti = 0;
  int ct = 0, fi = 0;
  __device__ __forceinline__ void next(int nct, int nf) {
    if (++fi < nf) return;
    fi = 0;
    if (++ct < nct) return;
    ct = 0;
    ++ti;
  }
};

// Slab sl of the n > FT walk into `stage`: the rows' segments x[r0 : r0 +
// rows, f0 : f0 + fw] ([TM][XW]) and the candidate slab [FT][CT] (zero past
// L and past the features), one cp.async group.  Every thread calls it.
template <int CT, int VW>
__device__ __forceinline__ void issue_slab(const KppArgs& a,
                                           const KppLayout& lay,
                                           unsigned char* stage,
                                           const Slab& sl) {
  constexpr int XW = row_floats(VW);
  const int t = threadIdx.x;
  const int n = a.n;
  const int f0 = sl.fi * FT;
  const int fw = min(FT, n - f0);
  const int64_t r0 = ((int64_t)blockIdx.x + sl.ti * gridDim.x) * TM;
  const int rows = (int)(a.m - r0 < TM ? a.m - r0 : TM);
  float* xs = reinterpret_cast<float*>(stage);
  const float* src = a.x + r0 * n + f0;
  // thread t: word (or 16-byte chunk) w of rows t / per, t / per + TM /
  // per, ...
  constexpr int per = VW == 4 ? FT / 4 : FT;
  const int w = VW * (t % per);
  if (w < fw)
    for (int row = t / per; row < rows; row += TM / per) {
      if constexpr (VW == 4)
        cp_async16(&xs[row * XW + w], src + (int64_t)row * n + w);
      else
        cp_async4(&xs[row * XW + w], src + (int64_t)row * n + w);
    }
  float* cs = reinterpret_cast<float*>(stage + lay.x_bytes);
  for (int q = t; q < FT * CT; q += TM) {
    const int f = q / CT;
    const int l = sl.ct * CT + (q - f * CT);
    if (l < a.L && f < fw)
      cp_async4(&cs[q], a.cands + (int64_t)l * n + f0 + f);
    else
      cs[q] = 0.f;
  }
  cp_async_commit();
}

// n > FT: slabs (point tile, candidate tile, feature tile) through the
// ring, copied by cp.async and retired a slab at a time by wait_group.
template <int CT, int VW>
__device__ __forceinline__ void tiled_body(const KppArgs& a,
                                           const KppLayout& lay,
                                           unsigned char* smem,
                                           int64_t my_tiles,
                                           float (&pacc)[CT]) {
  const int t = threadIdx.x;
  const int L = a.L, n = a.n;
  const int nct = (L + CT - 1) / CT;
  const int nf = (n + FT - 1) / FT;
  constexpr int S = STAGES_TILED;
  constexpr int XW = row_floats(VW);
  float* c2s = reinterpret_cast<float*>(smem + lay.c2);
  float* nd = reinterpret_cast<float*>(smem + lay.nd);
  float* psum = reinterpret_cast<float*>(smem + lay.psum);
  const int64_t steps = my_tiles * nct * nf;
  // one group a slab (empty past the last), so that the wait below
  // retires slab i's
  Slab ahead;  // slab i + S - 1
  for (int64_t i = 0; i < S - 1; ++i, ahead.next(nct, nf)) {
    if (i < steps)
      issue_slab<CT, VW>(a, lay, smem + (int)(i % S) * lay.stage_bytes,
                         ahead);
    else
      cp_async_commit();
  }
  float xsq = 0.f, dr = 0.f, c2acc = 0.f;
  float acc[CT];
  Slab sl;  // slab i
  for (int64_t i = 0; i < steps; ++i, sl.next(nct, nf), ahead.next(nct, nf)) {
    const int64_t ti = sl.ti;
    const int ct = sl.ct;
    const int fi = sl.fi;
    const int fw = min(FT, n - fi * FT);
    const int64_t r0 = ((int64_t)blockIdx.x + ti * gridDim.x) * TM;
    const int64_t r = r0 + t;
    const int rows = (int)(a.m - r0 < TM ? a.m - r0 : TM);
    if (fi == 0) {
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[j] = 0.f;
      c2acc = 0.f;
      if (ct == 0) {
        xsq = 0.f;
        dr = r < a.m ? a.d[r] : 0.f;
      }
    }
    cp_async_wait<S - 2>();  // this thread's copies of slab i
    __syncthreads();  // ... every thread's; stage (i - 1) % S and nd free
    if (i + S - 1 < steps)
      issue_slab<CT, VW>(
          a, lay, smem + (int)((i + S - 1) % S) * lay.stage_bytes, ahead);
    else
      cp_async_commit();
    const unsigned char* st = smem + (int)(i % S) * lay.stage_bytes;
    const float* cs = reinterpret_cast<const float*>(st + lay.x_bytes);
    row_dots<CT, VW>(reinterpret_cast<const float*>(st) + t * XW, cs, fw,
                     xsq, acc, ct == 0);
    if (t < CT) c2acc = sq_chain(cs + t, CT, fw, c2acc);
    if (fi == nf - 1) {
      if (t < CT) c2s[t] = c2acc;
      __syncthreads();
      tile_epilogue<CT>(a, nd, psum, c2s, ct * CT, r0, rows, dr, xsq, acc,
                        pacc, ti == 0);
    }
  }
  cp_async_wait<0>();
}

// The CTA's potentials into its partials; the last CTA to finish adds
// the partials in CTA order into pot and resets the ticket.
template <int CT>
__device__ __forceinline__ void finish_pot(const KppArgs& a,
                                           const KppLayout& lay,
                                           unsigned char* smem,
                                           int64_t my_tiles,
                                           const float (&pacc)[CT]) {
  const int t = threadIdx.x;
  const int L = a.L;
  float* nd = reinterpret_cast<float*>(smem + lay.nd);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const float* psum = reinterpret_cast<const float*>(smem + lay.psum);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);
  float* P = a.part + (int64_t)blockIdx.x * L;
  __syncthreads();  // nd and psum are final
  if (my_tiles == 0) {
    for (int l = t; l < L; l += TM) P[l] = 0.f;
  } else if (L <= CT) {
    const int s = L | 1;
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j < L) nd[t * s + j] = pacc[j];
    __syncthreads();
    column_tree(nd, L, s);
    if (t < L) P[t] = nd[t];
  } else {
    for (int l = t; l < L; l += TM) P[l] = psum[l];
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (t == 0) *flag = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // chunk c of NC = TM / L: CTAs [c * CH, (c + 1) * CH) in order, by
  // thread (c, l); then the chunks by a fixed tree
  const int G = (int)gridDim.x;
  const int NC = TM / L;
  const int CH = (G + NC - 1) / NC;
  if (t < NC * L) {
    const int c = t / L;
    const int l = t - c * L;
    const int g1 = min(G, (c + 1) * CH);
    float sum = 0.f;
#pragma unroll 4
    for (int g = c * CH; g < g1; ++g)
      sum += __ldcg(a.part + (int64_t)g * L + l);
    red[c * L + l] = sum;
  }
  __syncthreads();
  int w = 1;
  while (2 * w < NC) w *= 2;
  for (; w > 0; w >>= 1) {  // chunks c and c + w, a fixed tree
    if (t < w * L && t + w * L < NC * L) red[t] += red[t + w * L];
    __syncthreads();
  }
  if (t < L) a.pot[t] = red[t];
  if (t == 0) *a.ticket = 0;
}

template <int CT, int VW, bool TILED>
__global__ void __launch_bounds__(TM) kpp_probe_kernel(KppArgs a) {
  const KppLayout lay = kpp_layout(a.n, a.L, CT);
  unsigned char* smem = dynamic_smem();
  const int64_t my_tiles =
      (int64_t)blockIdx.x < a.num_tiles
          ? (a.num_tiles - 1 - blockIdx.x) / gridDim.x + 1
          : 0;
  float pacc[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) pacc[j] = 0.f;
  if (my_tiles > 0) {
    if constexpr (TILED)
      tiled_body<CT, VW>(a, lay, smem, my_tiles, pacc);
    else
      resident_body<CT, VW>(a, lay, smem, my_tiles, pacc);
  }
  finish_pot<CT>(a, lay, smem, my_tiles, pacc);
}

template <int CT, int VW, bool TILED>
int launch_as(const KppArgs& a, int grid, cudaStream_t st) {
  auto kernel = kpp_probe_kernel<CT, VW, TILED>;
  const int smem = kpp_layout(a.n, a.L, CT).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  REPRO_LAUNCH(kernel, grid, TM, smem, st, a);
  return (int)cudaGetLastError();
}

template <int CT>
int launch_ct(const KppArgs& a, int grid, cudaStream_t st) {
  // 16-byte reads of a row: x 16-byte aligned and rows of whole chunks
  const bool vec =
      (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 && a.n % 4 == 0;
  if (a.n > FT)
    return vec ? launch_as<CT, 4, true>(a, grid, st)
               : launch_as<CT, 1, true>(a, grid, st);
  return vec ? launch_as<CT, 4, false>(a, grid, st)
             : launch_as<CT, 1, false>(a, grid, st);
}

template <int CT, bool TILED>
int ctas_per_sm_as(int L, int n) {
  auto kernel = kpp_probe_kernel<CT, 1, TILED>;
  const int smem = kpp_layout(n, L, CT).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, TM,
                                                      smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// The candidate tile of L candidates: 4, 8 or 32 dots a row.
inline int candidate_tile(int L) { return L <= 4 ? 4 : L <= 8 ? 8 : 32; }

// One launch at candidate tile ct (4, 8 or 32; any ct gives the same newd).
int kpp_launch(const KppArgs& a, int grid, int ct, cudaStream_t st) {
  if (ct == 4) return launch_ct<4>(a, grid, st);
  if (ct == 8) return launch_ct<8>(a, grid, st);
  if (ct == 32) return launch_ct<32>(a, grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

using namespace repro;

// x [m,n], cands [L,n], d [m] (f32, 4-byte aligned); newd: [m, L]; part:
// scratch [grid, L]; pot: [L]; ticket: an int at zero that no other launch
// in flight uses.  The last CTA leaves it at zero, so launches in order on
// one stream (one K-means++ seeding's slots, core/kmeanspp.py) may share
// it.
extern "C" int repro_kpp_probe(const float* x, const float* cands,
                               const float* d, float* newd, float* part,
                               float* pot, int* ticket, int64_t m, int L,
                               int n, int grid, void* stream) {
  const KppArgs a{x, cands, d, newd, part, pot, ticket, m, L, n,
                  (m + TM - 1) / TM};
  return kpp_launch(a, grid, candidate_tile(L), (cudaStream_t)stream);
}

// CTAs of kernel P an SM holds at (L, n) (its shared memory), or minus a
// CUDA error.
extern "C" int repro_kpp_probe_ctas_per_sm(int L, int n) {
  const int ct = candidate_tile(L);
  const bool tiled = n > FT;
  if (ct == 4) return tiled ? ctas_per_sm_as<4, true>(L, n)
                            : ctas_per_sm_as<4, false>(L, n);
  if (ct == 8) return tiled ? ctas_per_sm_as<8, true>(L, n)
                            : ctas_per_sm_as<8, false>(L, n);
  return tiled ? ctas_per_sm_as<32, true>(L, n)
               : ctas_per_sm_as<32, false>(L, n);
}
