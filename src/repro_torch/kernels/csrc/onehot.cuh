// The fused CTA bodies as kernels A-D and A8-D8 (and their dma twins) ran
// them before their accumulate phase became a sorted scatter
// (common.cuh:fused_cta, fused_cta_q): the same argmin and objective, then
// the dense one-hot contraction of each point tile into the CTA's partials.
// No kernel of the library includes this file.  It is the yardstick of the
// host tests (tests/test_torch_csrc.py), which hold the sorted scatter
// bitwise to it under every policy, as common.cuh:assign_cta is kernel B's.
#pragma once

#include "common.cuh"

namespace repro {

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

// The float body (common.cuh:fused_cta's arguments) with the one-hot
// contraction.
template <class Ops, class Load = SyncLoad>
__device__ __forceinline__ void fused_cta_onehot(
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

// The int8 body (common.cuh:fused_cta_q's arguments) with the one-hot
// contraction.
template <class Load = SyncLoad>
__device__ __forceinline__ void fused_cta_q_onehot(
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
