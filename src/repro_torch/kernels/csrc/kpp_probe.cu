// Kernel P: kpp_probe — the K-means++ candidate probe in one pass.
//
// Replaces the Pallas kernel repro/kernels/kpp_probe.py:kpp_probe_pallas
// (_kpp_kernel).  For points x [m,n] f32, L candidate seeds cands [L,n] f32
// and the current distances d [m] f32 it returns
//   newd [m,L] = min(d, max((||c_l||^2 - 2 x.c_l) + ||x||^2, 0))
//   pot [L]    = sum over the m rows of newd[:, l]
// with ||x||^2, ||c_l||^2 and x.c_l sequential f32 FMAs over the features,
// associated as the plain version (kpp_probe.py:kpp_probe_plain).
//
// Bound: bytes.  It reads x and d once and writes newd once: at the
// seeding shape (m = 64,000, n = 28, L = 3) 7.17 + 0.26 + 0.77 = 8.19 MB,
// 2.45 us at 3.35 TB/s, against 2mLn = 10.8 MFLOP.
// Design: kernel A's layout.  One CTA of TM threads walks point tiles of TM
// rows, thread t owning row t; the point slab and a candidate tile of LT
// candidates are staged in shared memory by (candidate tile, feature tile),
// the LT dots of a row held in registers.  Each tile's newd goes to global
// memory and, through shared memory, into the CTA's per-candidate partial
// potentials (column sums in a fixed two-level order: TM / LT parts of LT
// rows, then the parts in order); a second launch adds the per-CTA partials
// in CTA order.  No atomics: repeated launches are bitwise equal.
#include "common.cuh"

using namespace repro;

constexpr int LT = 32;           // candidates per tile (register dots)
constexpr int PARTS = TM / LT;   // row parts of a column sum

struct KppSmem {
  union {
    float xs[TM][FT + 1];  // point slab (row-per-thread reads)
    float nd[TM][LT + 1];  // the tile's newd, once the dots are done
  };
  float cs[LT][FT];        // candidate slab (broadcast reads)
  float c2[LT];            // ||c||^2 of the candidate tile
  float part[PARTS][LT];   // column sums of the row parts
};

extern "C" __global__ void __launch_bounds__(TM)
kpp_probe_kernel(const float* __restrict__ x, const float* __restrict__ cands,
                 const float* __restrict__ d, float* __restrict__ newd,
                 float* __restrict__ part, int64_t m, int L, int n,
                 int64_t num_tiles) {
  __shared__ KppSmem s;
  const int t = threadIdx.x;
  float* P = part + blockIdx.x * (int64_t)L;
  if (blockIdx.x >= num_tiles) {
    zero_partials(P, (int64_t)L);
    return;
  }
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    const int64_t r = r0 + t;
    const bool valid = r < m;
    const float dr = valid ? d[r] : 0.f;
    float xsq = 0.f;
    for (int l0 = 0; l0 < L; l0 += LT) {
      float acc[LT];
#pragma unroll
      for (int j = 0; j < LT; ++j) acc[j] = 0.f;
      float c2acc = 0.f;
      for (int f0 = 0; f0 < n; f0 += FT) {
        const int fw = min(FT, n - f0);
        __syncthreads();  // earlier readers of s.xs / s.nd / s.cs are done
        load_x_tile(s, x, m, n, r0, f0, fw);
        for (int q = t; q < LT * FT; q += TM) {
          const int j = q / FT;
          const int col = q - j * FT;
          s.cs[j][col] = (l0 + j < L && col < fw)
                             ? cands[(int64_t)(l0 + j) * n + f0 + col]
                             : 0.f;
        }
        __syncthreads();
        if (t < LT) {
          for (int f = 0; f < fw; ++f)
            c2acc = fmaf(s.cs[t][f], s.cs[t][f], c2acc);
        }
        for (int f = 0; f < fw; ++f) {
          const float xv = s.xs[t][f];
          if (l0 == 0) xsq = fmaf(xv, xv, xsq);
#pragma unroll
          for (int j = 0; j < LT; ++j) acc[j] = fmaf(xv, s.cs[j][f], acc[j]);
        }
      }
      if (t < LT) s.c2[t] = c2acc;
      __syncthreads();  // s.xs is read no more; s.c2 is written
      const int lw = min(LT, L - l0);
#pragma unroll
      for (int j = 0; j < LT; ++j) {
        float v = 0.f;
        if (j < lw) {
          const float dc = fmaxf((s.c2[j] - 2.f * acc[j]) + xsq, 0.f);
          v = fminf(dr, dc);
          if (valid) newd[r * L + l0 + j] = v;
        }
        s.nd[t][j] = valid ? v : 0.f;
      }
      __syncthreads();
      {  // column j = t % LT, rows p*LT .. p*LT + LT-1 of part p = t / LT
        const int j = t % LT;
        const int p = t / LT;
        float sum = 0.f;
        for (int i = 0; i < LT; ++i) sum += s.nd[p * LT + i][j];
        s.part[p][j] = sum;
      }
      __syncthreads();
      if (t < lw) {
        float sum = 0.f;
        for (int p = 0; p < PARTS; ++p) sum += s.part[p][t];
        float* dst = P + l0 + t;
        *dst = tile == blockIdx.x ? sum : *dst + sum;
      }
    }
  }
}

extern "C" __global__ void kpp_probe_reduce(const float* __restrict__ part,
                                            float* __restrict__ pot, int L,
                                            int G) {
  reduce_partials(part, pot, (int64_t)L, G);
}

// x [m,n], cands [L,n], d [m] (f32); newd: [m, L]; part: scratch [grid, L];
// pot: [L].
extern "C" int repro_kpp_probe(const float* x, const float* cands,
                               const float* d, float* newd, float* part,
                               float* pot, int64_t m, int L, int n, int grid,
                               void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  kpp_probe_kernel<<<grid, TM, 0, st>>>(x, cands, d, newd, part, m, L, n,
                                        num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kpp_probe_reduce<<<reduce_grid(L), 256, 0, st>>>(part, pot, L, grid);
  return (int)cudaGetLastError();
}
