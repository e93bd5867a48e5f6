// The sorted-scatter update of kernels C, C16, C3 (update.cu,
// update_bf16.cu) and C8 (update_int8.cu): per-cluster sums and counts of
// x [m,n] under ids [m], where an id outside [0, k) adds nothing.
//
// The update is a scatter: each row adds into one cluster, O(m n) work,
// bound by bytes.  It runs as two launches, with no atomics.
//
// 1. Tile pass, grid (point tiles, feature blocks).  A CTA takes one tile
//    of TM rows and one block of `fb` features (128 bytes of a row).  It
//    sorts the tile's rows in shared memory by the key (id, row), so that
//    each cluster present in the tile is one run of rows in ascending row
//    order; rows with an id outside [0, k) sort last and belong to no run.
//    One thread sums a run's values of one feature, in row order from +0,
//    and writes the run's record: the tile sum T_t[j, f].  A tile's
//    records take the slots t * slots .. t * slots + runs - 1 (slots =
//    min(TM, k)), so the scratch is bounded by the rows, not by k n.  The
//    feature block 0 CTA also writes the run lengths (the tile's counts)
//    and the tile's column of the index idx [k, tiles]: the slot of
//    cluster j in tile t, or -1 where j is absent.  The sort, the run
//    table and the sum policies are common.cuh's (find_runs, Sum*), which
//    the fused bodies share.
// 2. Reduce, one CTA per cluster j (and block of features), one thread per
//    output element (j, f) (and per count j).  It keeps j's present tiles
//    and folds their sums in the association of the one-hot kernels
//    this replaced, whose launch had G CTAs, CTA g walking the tiles g,
//    g + G, g + 2G, ... into its partial P_g, and a second launch adding
//    the partials in CTA order:
//        P_g = (T_g + T_{g+G}) + T_{g+2G} + ...,
//        out = ((+0 + P_0) + P_1) + ... + P_{G-1}.
//    G is that launch's grid (build.grid(device, m, k n + k)), an ordering
//    constant here.  idx holds each tile at its position in that order
//    (class g's tiles in turn), so the reduce walks j's row front to back.
//
// The result is bitwise the one-hot kernels'.  Their tile sum added
// (ids_i == j ? x : +0) over all TM rows from +0; here only the members
// are added.  Skipping a +0 term is exact: a sum that starts at +0 under
// round to nearest is never -0 (x + y is -0 only when both are -0), and
// s + (+0) == s for every s that is not -0 (infinities included; a NaN
// stays a NaN).
// For the same reason the reduce skips an absent tile (the one-hot tile
// sum was +0) and a CTA class with no present tile (P_g was +0).  Counts
// and the int8 kernel's int32 sums are exact, so their order does not
// matter; they take the same path all the same.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int ROW_BLOCK_BYTES = 128;    // bytes of a row per feature block

template <class X>
struct ScatterSmem {
  static constexpr int fb = ROW_BLOCK_BYTES / (int)sizeof(X);
  alignas(16) X xs[TM][fb];       // the tile's feature block
  TileRuns runs;                  // its rows grouped by cluster
};

// Values per record: n, rounded up to 4 so that every record starts on
// 16 bytes (the reduce copies records 16 bytes at a time).
__host__ __device__ constexpr int record_stride(int n) {
  return (n + 3) / 4 * 4;
}

// The tile pass's grid extent over features, for elements X.
template <class X>
__host__ __device__ constexpr int tile_blocks(int n) {
  return (n + ScatterSmem<X>::fb - 1) / ScatterSmem<X>::fb;
}

// s.xs = x[r0 : r0+TM, f0 : f0+fw]; rows past m are left as they are (no
// run reads them).  16-byte loads when every row segment starts on 16
// bytes (x aligned and a row a multiple of 16 bytes; f0 is a multiple of
// fb, 128 bytes); else one element per load, which covers any n and a
// bf16 or int8 row that does not start on a word.
template <class X>
__device__ __forceinline__ void load_block(ScatterSmem<X>& s,
                                           const X* __restrict__ x,
                                           int64_t m, int n, int64_t r0,
                                           int f0, int fw) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     (uintptr_t)n * sizeof(X)) & 15) == 0;
  if (vec) {
    const int cpr = fw * (int)sizeof(X) / 16;  // 16-byte chunks per row
    for (int q = threadIdx.x; q < TM * cpr; q += TM) {
      const int row = q / cpr;
      const int ch = q - row * cpr;
      const int64_t r = r0 + row;
      if (r < m)
        reinterpret_cast<uint4*>(&s.xs[row][0])[ch] =
            reinterpret_cast<const uint4*>(x + r * n + f0)[ch];
    }
  } else {
    for (int q = threadIdx.x; q < TM * fw; q += TM) {
      const int row = q / fw;
      const int col = q - row * fw;
      const int64_t r = r0 + row;
      if (r < m) s.xs[row][col] = x[r * n + f0 + col];
    }
  }
}

// Position of tile t in the reduce's order: the tiles of class 0 (0, G,
// 2G, ...), then those of class 1, ...; class g holds T/G tiles, one more
// when g < T % G.
__device__ __forceinline__ int64_t order_position(int64_t t, int64_t T,
                                                  int G) {
  const int64_t g = t % G;
  return g * (T / G) + min(g, T % G) + t / G;
}

// The tile pass (see the top of this file).  Grid (tiles, tile_blocks(n)),
// TM threads: CTA (t, y) takes tile t's feature block y.  rec [tiles *
// slots, record_stride(n)] of Sum::S, rcnt [tiles * slots] f32, idx [k,
// tiles] int32.
template <class Sum>
__device__ __forceinline__ void scatter_tile(
    ScatterSmem<typename Sum::X>& s, const typename Sum::X* __restrict__ x,
    const int32_t* __restrict__ ids, typename Sum::S* __restrict__ rec,
    float* __restrict__ rcnt, int32_t* __restrict__ idx, int64_t m, int k,
    int n, int G) {
  constexpr int fb = ScatterSmem<typename Sum::X>::fb;
  const int t = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t tiles = gridDim.x;
  const int64_t r0 = tile * TM;
  const int f0 = (int)blockIdx.y * fb;
  const int fw = min(fb, n - f0);
  const int slots = min(TM, k);

  const int64_t r = r0 + t;
  const int id = r < m ? ids[r] : -1;
  s.runs.key[t] = run_key((id >= 0 && id < k) ? (unsigned)id : ABSENT);
  load_block(s, x, m, n, r0, f0, fw);
  find_runs(s.runs, k);

  // one warp per run, one lane per feature: the run's rows in order
  const TileRuns& rs = s.runs;
  const int runs = rs.runs;
  const int64_t base = tile * slots;
  const int warp = t / 32, lane = t % 32;
  for (int q = warp; q < runs; q += WARPS) {
    const int p0 = rs.start[q], p1 = rs.start[q + 1];
    typename Sum::S* dst = rec + (base + q) * record_stride(n) + f0;
    for (int f = lane; f < fw; f += 32) {
      Sum acc;
      for (int p = p0; p < p1; ++p) acc.add(s.xs[rs.row[p]][f]);
      dst[f] = acc.get();
    }
  }
  if (blockIdx.y != 0) return;
  for (int q = t; q < runs; q += TM)
    rcnt[base + q] = (float)(rs.start[q + 1] - rs.start[q]);
  const int64_t pos = order_position(tile, tiles, G);
  for (int j = t; j < k; j += TM) {
    int lo = 0, hi = runs;  // the first run whose cluster is >= j
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rs.rid[mid] < j)
        lo = mid + 1;
      else
        hi = mid;
    }
    idx[(int64_t)j * tiles + pos] =
        (lo < runs && rs.rid[lo] == j) ? (int32_t)(base + lo) : -1;
  }
}

// The reduce (see the top of this file).  Grid (k, reduce_blocks(n)), RT
// threads: CTA (j, y) folds cluster j's tile sums for the columns c =
// y * RT + t: the features c < n, and the counts at c = count_column(n),
// the first column of a warp of their own (so that the counts' fold does
// not run after the sums' in the same warp).  The CTA takes j's row of idx
// RT positions at a time and lists the present ones (slot and class) in
// order in shared memory.  It copies the listed records' columns into a
// shared buffer with cp.async, 16 bytes a copy, all in flight at once;
// then each thread folds its column from there without a branch.  An
// absent tile costs nothing.
constexpr int RT = 128;                 // threads of a reduce CTA
constexpr int REDUCE_BUFFER = 10240;    // 4-byte values (40 KB), at most

__host__ __device__ constexpr int count_column(int n) {
  return (n + 31) / 32 * 32;
}
__host__ __device__ constexpr int reduce_blocks(int n) {
  return count_column(n) / RT + 1;
}
// The reduce's buffer, in 4-byte values: room for the entries a cluster
// is likely to have in one chunk — at most min(T, RT), and twice the rows
// per cluster m / k (at least 16): a cluster has no more present tiles
// than rows — times the (16-byte rounded) sum columns of a CTA, at most
// REDUCE_BUFFER.  A cluster with more entries takes several batches: the
// size sets the speed only (a large buffer lowers the CTAs per SM).
inline int reduce_buffer(int64_t T, int n, int64_t m, int k) {
  int64_t entries = 2 * ((m + k - 1) / k);
  entries = entries < 16 ? 16 : entries;
  entries = entries < T ? entries : T;
  entries = entries < RT ? entries : RT;
  const int64_t want = entries * record_stride(n < RT ? n : RT);
  return (int)(want < 1 ? 1 : (want > REDUCE_BUFFER ? REDUCE_BUFFER : want));
}

#ifndef REPRO_HOST_ASYNC_COPY
// An asynchronous 16-byte copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
#endif

struct ReduceSmem {
  int slot[RT];        // idx row: this chunk's slots
  int lslot[RT];       // the present ones, in order ...
  int lcls[RT];        // ... and their class (CTA of the one-hot kernels)
  float cval[RT];      // the counts of a batch of listed entries
  int wsum[RT / 32];   // present positions per warp
  int count;           // present positions in the chunk
};

// One thread's fold: out, the partial P of the class g being walked.  At
// an entry of another class, P joins out and restarts from the entry, else
// the entry joins P.  out and P start at +0, so the first entry adds +0 to
// out (exact); finish() adds the last class.
template <class V>
struct Fold {
  V out = V(0), P = V(0);
  int g = -1;
  __device__ __forceinline__ void add(int cls, V v) {
    const bool starts = cls != g;
    const V joined = P + v;
    out = starts ? out + P : out;
    P = starts ? v : joined;
    g = cls;
  }
  __device__ __forceinline__ V finish() const { return out + P; }
};

// `buf`: the launch's dynamic shared memory, `room` 4-byte values
// (reduce_buffer).
template <class S>
__device__ __forceinline__ void scatter_reduce(
    ReduceSmem& rs, S* buf, int room, const S* __restrict__ rec,
    const float* __restrict__ rcnt, const int32_t* __restrict__ idx,
    S* __restrict__ osum, float* __restrict__ ocnt, int k, int n, int64_t T,
    int G) {
  static_assert(sizeof(S) == 4, "the buffer holds 4-byte values");
  const int t = threadIdx.x;
  const int j = blockIdx.x;
  const int f0 = (int)blockIdx.y * RT;
  const int f = f0 + t;                    // the column
  const int fc = count_column(n);
  const bool has_counts = fc - f0 < RT;
  const int nr = record_stride(n);
  const int bs = f0 < n ? record_stride(min(RT, n - f0)) : 0;  // buffer row
  const int chunks = bs / 4;               // 16-byte copies per entry
  const int entries = bs > 0 ? min(RT, room / bs) : RT;
  const int64_t per = T / G, extra = T % G, big = extra * (per + 1);
  Fold<S> sums;
  Fold<float> counts;
  for (int64_t c0 = 0; c0 < T; c0 += RT) {
    const int64_t p = c0 + t;
    const int slot = p < T ? idx[(int64_t)j * T + p] : -1;
    const int present = slot >= 0 ? 1 : 0;
    rs.slot[t] = slot;
    __syncthreads();
    int rank = 0;                     // present positions before p: in
    for (int i = t & ~31; i < t; ++i)  // the warp, then in earlier warps
      rank += rs.slot[i] >= 0 ? 1 : 0;
    if ((t & 31) == 31) rs.wsum[t >> 5] = rank + present;
    __syncthreads();
    for (int w = 0; w < (t >> 5); ++w) rank += rs.wsum[w];
    if (present) {
      rs.lslot[rank] = slot;
      rs.lcls[rank] = (int)(p < big ? p / (per + 1) : extra + (p - big) / per);
    }
    if (t == RT - 1) rs.count = rank + present;
    __syncthreads();
    const int count = rs.count;
    for (int e0 = 0; e0 < count; e0 += entries) {
      const int ne = min(entries, count - e0);
      for (int q = t; q < ne * chunks; q += RT) {
        const int e = q / chunks;
        const int c = q - e * chunks;
        cp_async16(buf + e * bs + 4 * c,
                   rec + (int64_t)rs.lslot[e0 + e] * nr + f0 + 4 * c);
      }
      if (has_counts)
        for (int e = t; e < ne; e += RT)
          cp_async4(&rs.cval[e], rcnt + rs.lslot[e0 + e]);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (f < n) {
        for (int e = 0; e < ne; ++e)
          sums.add(rs.lcls[e0 + e], buf[e * bs + t]);
      } else if (f == fc) {
        for (int e = 0; e < ne; ++e)
          counts.add(rs.lcls[e0 + e], rs.cval[e]);
      }
      __syncthreads();  // buf and cval are rewritten by the next batch
    }
  }
  if (f < n)
    osum[(int64_t)j * n + f] = sums.finish();
  else if (f == fc)
    ocnt[j] = counts.finish();
}

}  // namespace repro
