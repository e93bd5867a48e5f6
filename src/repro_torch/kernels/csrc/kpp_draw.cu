// Kernel G: kpp_draw — one K-means++ slot's D² draw, and the pick of the
// slot before it, on the card.
//
// For points x [s,n] f32, the slot's Gumbel noise [L,s] and the current
// distances d [s] it draws L candidate rows as the oracle chain
// (core/kmeanspp.py) does,
//   logit_i = total > 0 ? log(max(d_i, 1e-30)) : 0,   total = sum_i d_i,
//   idx_l   = argmax_i (noise[l, i] + logit_i),
// first index on ties and NaN first (torch.argmax's rule), and gathers
// them: cands [L,n] = x[idx] (and idx [L] int64).  The distances are >= 0
// (the oracle and kernel P both clamp at 0), so total > 0 exactly when
// some d_i > 0: no sum is needed.  Each CTA keeps, for each candidate row,
// the best entry under the logits and the best under none, and whether it
// saw a d_i > 0 (four candidate rows a pass over its rows, in registers,
// then reduced by warp shuffles); the last CTA to finish (an integer
// ticket, as in kernel P) reduces the CTAs' records and takes the ones the
// rule says.  (argmax's rule is a total order on (value, index), so the
// result does not depend on the grid.)
//
// With the previous slot's probe (newd [s,L] and pot [L] of kernel P) it
// first makes that slot's pick, b = argmin_l pot[l] (first index on ties,
// NaN first: torch.argmin's rule), on the card: every CTA computes b, and
// writes its rows of d as newd[:, b]; the last CTA copies the previous
// slot's candidate cands[b] to the centroid row c_row before it gathers
// the new candidates over it.  With no noise a launch makes only the pick,
// in one CTA (after a seeding's last slot).  The host never reads b.
//
// log is logf, as torch's float log on the card, and the sum noise + logit
// one f32 add, so that on equal d the draw is the oracle chain's, bit for
// bit.
//
// Bound: bytes.  It reads noise and newd's column (L + 1 floats a row,
// newd's rows in L-float strides), writes d, and reads it back L times
// from L2: at the codebook's seeding shape (s = 163,840, L = 3) about 3 MB,
// ~1 us at 3.35 TB/s, so a launch is held by its latency.
#include "common.cuh"

namespace repro {
namespace {

constexpr int DT = 256;  // threads a CTA
constexpr int WARPS = DT / 32;
constexpr int CL = 4;    // candidate rows a pass over the CTA's rows
constexpr int R = 4;     // rows a thread loads before it uses them

// (v, i) beats (w, j) under torch.argmax's rule: NaN first, then the larger
// value, then the smaller index.  j < 0: (w, j) is no entry yet.
__device__ __forceinline__ bool beats_max(float v, int i, float w, int j) {
  if (j < 0) return true;
  if (v != v) return w == w || i < j;
  if (w != w) return false;
  return v == w ? i < j : v > w;
}

// (v, i) becomes (w, j) where that beats it; j < 0 is no entry.
__device__ __forceinline__ void take(float& v, int& i, float w, int j) {
  if (j >= 0 && beats_max(w, j, v, i)) {
    v = w;
    i = j;
  }
}

// Every lane of the warp ends with the warp's best entry (a butterfly;
// the rule is a total order, so any order of the takes gives the same
// entry).  Every thread of the CTA calls it.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, off);
    const int j = __shfl_xor_sync(0xffffffffu, i, off);
    take(v, i, w, j);
  }
}

// The OR of `flag` over the CTA, in every thread (scratch: WARPS ints).
// Every thread calls it.
__device__ __forceinline__ int cta_any(int flag, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    flag |= __shfl_xor_sync(0xffffffffu, flag, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x / 32] = flag;
  __syncthreads();
  int any = 0;
  for (int w = 0; w < WARPS; ++w) any |= scratch[w];
  __syncthreads();  // scratch is read before it is written again
  return any;
}

struct DrawArgs {
  const float* x;      // [s, n]
  const float* noise;  // [L, s]
  float* d;            // [s]: read, or written from newd when newd is set
  const float* newd;   // [s, L] of the previous slot, or null
  const float* pot;    // [L] of the previous slot (with newd)
  float* c_row;        // the previous slot's centroid row [n] (with newd)
  float* cands;        // [L, n]: the previous slot's in, this slot's out
  int64_t* idx;        // [L]: this slot's candidate rows
  float* part_v;       // [grid, L, 2] the CTAs' best values
  int* part_i;         // [grid, L, 2] their rows, then [grid] flags
  int* ticket;         // zero before the launch; the last CTA resets it
  int64_t s;
  int L;
  int n;
};

// argmin of pot [L] under torch.argmin's rule (one thread).
__device__ __forceinline__ int pick_of(const float* pot, int L) {
  int b = 0;
  for (int l = 1; l < L; ++l) {
    const float v = pot[l], w = pot[b];
    if ((v != v && w == w) || v < w) b = l;
  }
  return b;
}

__global__ void __launch_bounds__(DT) kpp_draw_kernel(DrawArgs a) {
  __shared__ float wv[WARPS][2 * CL];
  __shared__ int wi[WARPS][2 * CL];
  __shared__ int scratch[WARPS];
  __shared__ int sb, slast;
  __shared__ int64_t sidx[128];
  const int t = threadIdx.x, lane = t & 31, warp = t / 32;
  const int L = a.L, n = a.n;
  if (t == 0) sb = a.newd != nullptr ? pick_of(a.pot, L) : 0;
  __syncthreads();
  const int b = sb;
  if (a.noise == nullptr) {  // the pick alone
    for (int f = t; f < n; f += DT) a.c_row[f] = a.cands[(int64_t)b * n + f];
    return;
  }
  const int64_t per = (a.s + gridDim.x - 1) / gridDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * per;
  const int64_t r1 = r0 + per < a.s ? r0 + per : a.s;
  int any = 0;
  // CL candidate rows a pass: each thread's best entries in registers
  // (under the logits, v1, and under none, v0), then the warp's, then the
  // CTA's into its partials.  The first pass writes d from newd.
  for (int l0 = 0; l0 < L; l0 += CL) {
    float v1[CL], v0[CL];
    int i1[CL], i0[CL];
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      v1[c] = v0[c] = 0.f;
      i1[c] = i0[c] = -1;
    }
    // R rows at a time: every load before the stores and the compares
    // that use it, so that a thread has R * (CL + 1) loads in flight
    const bool rewrite = l0 == 0 && a.newd != nullptr;
    for (int64_t base = r0 + t; base < r1; base += R * DT) {
      float dv[R], gv[R][CL];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int64_t i = base + (int64_t)k * DT;
        dv[k] = 0.f;
#pragma unroll
        for (int c = 0; c < CL; ++c) gv[k][c] = 0.f;
        if (i < r1) {
          dv[k] = rewrite ? a.newd[i * L + b] : a.d[i];
#pragma unroll
          for (int c = 0; c < CL; ++c)
            if (l0 + c < L) gv[k][c] = a.noise[(int64_t)(l0 + c) * a.s + i];
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int64_t i = base + (int64_t)k * DT;
        if (i < r1) {
          if (rewrite) a.d[i] = dv[k];
          if (l0 == 0) any |= dv[k] > 0.f;
          const float logit = logf(dv[k] < 1e-30f ? 1e-30f : dv[k]);
#pragma unroll
          for (int c = 0; c < CL; ++c) {
            if (l0 + c < L) {
              take(v1[c], i1[c], gv[k][c] + logit, (int)i);
              take(v0[c], i0[c], gv[k][c], (int)i);
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      warp_best(v1[c], i1[c]);
      warp_best(v0[c], i0[c]);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CL; ++c) {
        wv[warp][2 * c] = v1[c];
        wi[warp][2 * c] = i1[c];
        wv[warp][2 * c + 1] = v0[c];
        wi[warp][2 * c + 1] = i0[c];
      }
    }
    __syncthreads();
    if (t < 2 * CL && l0 + t / 2 < L) {  // record t of the CTA: its warps'
      float v = 0.f;
      int i = -1;
      for (int w = 0; w < WARPS; ++w) take(v, i, wv[w][t], wi[w][t]);
      const int64_t q = ((int64_t)blockIdx.x * L + l0) * 2 + t;
      a.part_v[q] = v;
      a.part_i[q] = i;
    }
    __syncthreads();  // wv is read before the next pass writes it
  }
  any = cta_any(any, scratch);
  const int G = (int)gridDim.x;
  int* flags = a.part_i + (int64_t)G * L * 2;
  if (t == 0) flags[blockIdx.x] = any;
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (t == 0) slast = atomicAdd(a.ticket, 1) == G - 1;
  __syncthreads();
  if (!slast) return;
  __threadfence();
  // the last CTA: total > 0 over the grid, then each candidate row's best
  // record (row l by warp l % WARPS, its lanes over the CTAs)
  int seen = 0;
  for (int g = t; g < G; g += DT) seen |= __ldcg(flags + g);
  const int e = cta_any(seen, scratch) ? 0 : 1;  // under the logits, or none
  for (int l0 = 0; l0 < L; l0 += WARPS) {
    const int l = l0 + warp;
    float v = 0.f;
    int i = -1;
    if (l < L)
      for (int g = lane; g < G; g += 32) {
        const int64_t q = ((int64_t)g * L + l) * 2 + e;
        take(v, i, __ldcg(a.part_v + q), __ldcg(a.part_i + q));
      }
    warp_best(v, i);
    if (l < L && lane == 0) sidx[l] = i;
  }
  __syncthreads();
  if (t < L) a.idx[t] = sidx[t];
  if (a.newd != nullptr)  // the previous slot's pick, before it is overwritten
    for (int f = t; f < n; f += DT) a.c_row[f] = a.cands[(int64_t)b * n + f];
  __syncthreads();
  const int64_t ln = (int64_t)L * n;
  for (int64_t base = t; base < ln; base += R * DT) {
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {  // R loads in flight
      const int64_t q = base + (int64_t)k * DT;
      const int l = (int)(q / n);
      v[k] = q < ln ? a.x[sidx[l] * n + (q - (int64_t)l * n)] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (base + (int64_t)k * DT < ln) a.cands[base + (int64_t)k * DT] = v[k];
  }
  if (t == 0) *a.ticket = 0;
}

}  // namespace
}  // namespace repro

using namespace repro;

// One slot's draw (noise non-null) over x [s,n], with the previous slot's
// pick when newd is non-null; with noise null, the pick alone.  part_v:
// [grid * L * 2] floats; part_i: [grid * L * 2 + grid] ints; ticket: zero
// before the launch, and left at zero by it (keep one per stream and
// seeding).  L <= 128, s < 2^31.
extern "C" int repro_kpp_draw(const float* x, const float* noise, float* d,
                              const float* newd, const float* pot,
                              float* c_row, float* cands, int64_t* idx,
                              float* part_v, int* part_i, int* ticket,
                              int64_t s, int L, int n, int grid,
                              void* stream) {
  if (L < 1 || L > 128 || s < 1 || s > 0x7fffffff || grid < 1 ||
      (noise == nullptr && (newd == nullptr || grid != 1)))
    return (int)cudaErrorInvalidValue;
  const DrawArgs a{x,      noise,  d,      newd, pot, c_row, cands,
                   idx,    part_v, part_i, ticket, s, L,     n};
  REPRO_LAUNCH(kpp_draw_kernel, grid, DT, 0, (cudaStream_t)stream, a);
  return (int)cudaGetLastError();
}
