"""The CUDA kernels' source logic, run on the CPU.

There is no CUDA compiler or card here, so the kernels themselves run only
on the card (``test_torch_cuda.py``, marked ``cuda``).  This file checks
their *logic* — tiling, indexing, ragged edges, the tie rule, the ordered
per-CTA reduction — by compiling ``kernels/csrc/*.cu`` with the host C++
compiler against a small stand-in for the CUDA runtime: each CTA runs as
``blockDim`` host threads, ``__syncthreads`` is a barrier and
``__shared__`` a static shared by the CTA's threads, the rounding
intrinsics (``__fmul_rn``, ``__fadd_rn``, ``__fsub_rn``) single float
operations, and ``__nv_bfloat16`` its 16 bits with round-to-nearest-even
conversions.  The dma kernels' ``cp.async`` copies are deferred: a copy
lands when the ``cp.async.wait_group`` that retires its group runs, as on
the card, so a slab read before its wait, or a slot overwritten while it is
read, shows as a wrong result; their dynamic shared memory is one static
buffer (the CTAs run one after another).  Kernel P's ``cp.async.bulk``
copies fill their destination with NaN when issued and land when an
``mbarrier`` wait finds every expected arrival of their phase made, so a
tile read before its wait, or a stage overwritten while it is read, shows
too; its integer ticket is an atomic add and ``__threadfence`` a fence.
The tensor-core kernels B8 and B16 (``assign_mma.cuh``) run their entry
points (``REPRO_LAUNCH`` runs the CTAs); each ``wgmma`` is emulated on the card's fragment layout, reading
its operands through the 128-byte swizzle, and held like a copy until the
``wgmma.wait_group`` that retires it; the warp intrinsics
(``__shfl_sync``, ``__shfl_xor_sync``, ``__shfl_up_sync``,
``__ballot_sync``, ``__match_any_sync``) go through one slot a thread.
Results are held against the port's plain versions with the same
tolerances as on the card; the int8 kernels' int32 sums and B8 bitwise;
each dma kernel bitwise its blocks twin; the update kernels (a sorted
scatter) bitwise ``parent_order_update``, the order of the one-hot kernels
they replaced, and bitwise kernel A's sums on kernel A's ids; the fused
kernels A and D and their dma twins (whose CTA bodies scatter sorted runs
too) bitwise the one-hot body they replaced (``onehot.cuh``) under every
policy.
"""
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, distance, fused_step, ref, update
from repro_torch.kernels import precision as px
from repro_torch.kernels.kpp_probe import kpp_probe_plain
from test_torch_cuda import (
    d_bound, int8_exact_blobs, near_ties_int8, parent_order_update,
    sums_bound,
)

RTOL = 1e-5

STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
struct dim3s { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3s threadIdx, blockIdx;
inline dim3s blockDim, gridDim;
inline std::barrier<>* cta_barrier = nullptr;
inline void __syncthreads() { cta_barrier->arrive_and_wait(); }
using std::min;
// one IEEE single operation each, rounded to nearest (no contraction)
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0;
const int cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
// CTAs one after another (x fastest); the threads of a CTA concurrently.
inline void launch2(unsigned gx, unsigned gy, unsigned block,
                    std::function<void()> fn) {
  gridDim.x = gx;
  gridDim.y = gy;
  blockDim.x = block;
  for (unsigned by = 0; by < gy; ++by) {
    for (unsigned bx = 0; bx < gx; ++bx) {
      std::barrier<> bar(block);
      cta_barrier = &bar;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block; ++t)
        ts.emplace_back([&, t, bx, by] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          fn();
        });
      for (auto& th : ts) th.join();
    }
  }
}
inline void launch(unsigned grid, unsigned block, std::function<void()> fn) {
  launch2(grid, 1, block, fn);
}
// a kernel launch inside an entry point runs its CTAs here
#define REPRO_HOST_LAUNCH
#define REPRO_LAUNCH(kernel, grid, block, smem, stream, ...) \
  launch((grid), (block), [&] { kernel(__VA_ARGS__); })
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
// cp.async: each copy is held until the wait_group that retires its group
// (a copy from nullptr zero-fills)
#define REPRO_HOST_ASYNC_COPY
struct PendingCopy { void* dst; const void* src; };
inline thread_local std::vector<PendingCopy> cp_open;
inline thread_local std::vector<std::vector<PendingCopy>> cp_groups;
inline void cp_async4(void* dst, const void* src) {
  cp_open.push_back({dst, src});
}
inline void cp_async16(void* dst, const void* src) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
      & 15) std::abort();                  // the card needs 16-byte alignment
  for (int w = 0; w < 4; ++w)
    cp_async4((char*)dst + 4 * w, (const char*)src + 4 * w);
}
inline void cp_async_commit() {
  cp_groups.push_back(cp_open);
  cp_open.clear();
}
template <int N>
inline void cp_async_wait() {
  while (cp_groups.size() > (size_t)N) {
    for (const PendingCopy& c : cp_groups.front()) {
      if (c.src) std::memcpy(c.dst, c.src, 4);
      else std::memset(c.dst, 0, 4);
    }
    cp_groups.erase(cp_groups.begin());
  }
}
// cp.async.bulk on mbarriers (kpp_probe.cu): a copy fills its destination
// with NaN bytes when it is issued and lands when a wait finds every
// expected arrival of its barrier's phase made (so every copy of the phase
// issued); the phase then completes.  A slab read before its wait, or a
// stage overwritten while it is read, shows as a wrong result.
#define REPRO_HOST_BULK_COPY
struct PendingBulk { void* dst; const void* src; unsigned bytes; };
struct HostBarrier {
  unsigned count = 0, pending = 0, phase = 0;
  int64_t tx = 0;
  std::vector<PendingBulk> copies;
};
inline std::mutex barrier_mutex;
inline std::map<const void*, HostBarrier> host_barriers;
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> lock(barrier_mutex);
  host_barriers[bar] = HostBarrier{count, count, 0, 0, {}};
}
inline void mbar_fence_init() {}
inline void async_proxy_fence() {}
inline void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lock(barrier_mutex);
  HostBarrier& b = host_barriers.at(bar);
  if (b.pending == 0) std::abort();        // more arrivals than expected
  --b.pending;
  b.tx += bytes;
}
inline void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)
        | bytes) & 15) || bytes == 0)
    std::abort();                          // the card needs 16-byte units
  std::memset(dst, 0xFF, bytes);
  std::lock_guard<std::mutex> lock(barrier_mutex);
  host_barriers.at(bar).copies.push_back({dst, src, bytes});
}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  for (;;) {
    {
      std::lock_guard<std::mutex> lock(barrier_mutex);
      HostBarrier& b = host_barriers.at(bar);
      if ((b.phase & 1u) != parity) return;  // that phase has completed
      if (b.pending == 0) {
        for (const PendingBulk& c : b.copies) {
          std::memcpy(c.dst, c.src, c.bytes);
          b.tx -= c.bytes;
        }
        b.copies.clear();
        if (b.tx == 0) {
          ++b.phase;
          b.pending = b.count;
          return;
        }
      }
    }
    std::this_thread::yield();
  }
}
// the integer ticket and the loads of other CTAs' partials
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <class T>
inline T __ldcg(const T* p) { return *p; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, F, int, size_t) {
  *blocks = 1;
  return 0;
}
// dynamic shared memory: the CTAs of a launch run one after another
inline unsigned char* dynamic_smem() {
  alignas(16) static unsigned char smem[1 << 18];
  return smem;
}
// cp.async of 16 bytes, or of none (zero-fill)
inline void cp_async16_zfill(void* dst, const void* src, int bytes) {
  if (bytes == 16) {
    cp_async16(dst, src);
  } else {
    for (int w = 0; w < 4; ++w)
      cp_open.push_back({(char*)dst + 4 * w, nullptr});
  }
}
// __shfl_sync, __shfl_xor_sync: every thread of the CTA takes part (the
// kernels call them uniformly), through one slot a thread
inline uint32_t shfl_slot[1024];
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4);
  uint32_t u;
  std::memcpy(&u, &v, 4);
  shfl_slot[threadIdx.x] = u;
  __syncthreads();
  const uint32_t o = shfl_slot[(threadIdx.x & ~31u) + src];
  __syncthreads();
  T r;
  std::memcpy(&r, &o, 4);
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  static_assert(sizeof(T) == 4);
  uint32_t u;
  std::memcpy(&u, &v, 4);
  shfl_slot[threadIdx.x] = u;
  __syncthreads();
  const uint32_t o = shfl_slot[threadIdx.x ^ mask];
  __syncthreads();
  T r;
  std::memcpy(&r, &o, 4);
  return r;
}
// __ballot_sync: the warp's predicates as a bit mask, lane l at bit l
// (every thread of the CTA calls it), through the same slots
inline unsigned __ballot_sync(unsigned, int pred) {
  shfl_slot[threadIdx.x] = pred ? 1u : 0u;
  __syncthreads();
  unsigned mask = 0;
  for (unsigned l = 0; l < 32; ++l)
    mask |= shfl_slot[(threadIdx.x & ~31u) + l] << l;
  __syncthreads();
  return mask;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
// __match_any_sync: the lanes of the warp whose value equals this lane's
inline unsigned __match_any_sync(unsigned, unsigned v) {
  shfl_slot[threadIdx.x] = v;
  __syncthreads();
  unsigned mask = 0;
  for (unsigned l = 0; l < 32; ++l)
    mask |= (shfl_slot[(threadIdx.x & ~31u) + l] == v ? 1u : 0u) << l;
  __syncthreads();
  return mask;
}
// __shfl_up_sync: v of lane - delta (this lane's own below delta)
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  static_assert(sizeof(T) == 4);
  uint32_t u;
  std::memcpy(&u, &v, 4);
  shfl_slot[threadIdx.x] = u;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  const uint32_t o = shfl_slot[lane >= delta ? threadIdx.x - delta
                                             : threadIdx.x];
  __syncthreads();
  T r;
  std::memcpy(&r, &o, 4);
  return r;
}
// wgmma (assign_mma.cuh): each slab's products are held until the
// wgmma.wait_group that retires their group, so a product that reads a
// slab after it was overwritten, or accumulators read before their wait,
// show as a wrong result.  Thread t of a warpgroup owns register i, the
// element (row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
// col 8 (i / 4) + 2 (t % 4) + i % 2) of the 64-row product, as on the card;
// operands are read through the 128-byte swizzle (row r's 16-byte chunk q
// at r * 128 + (q ^ (r % 8)) * 16).
#define REPRO_HOST_MMA
inline void fence_proxy_async() {}
inline void wgmma_fence() {}
template <class Acc, int N>
inline void fence_operands(Acc (&)[N]) {}
inline thread_local std::vector<std::function<void()>> mma_open;
inline thread_local std::vector<std::vector<std::function<void()>>> mma_groups;
inline void wgmma_commit() {
  mma_groups.push_back(mma_open);
  mma_open.clear();
}
template <int N>
inline void wgmma_wait() {
  while (mma_groups.size() > (size_t)N) {
    for (auto& product : mma_groups.front()) product();
    mma_groups.erase(mma_groups.begin());
  }
}
inline const unsigned char* swizzled(const unsigned char* tile, int r, int b) {
  return tile + r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
}
inline float bf16_bits_at(const unsigned char* p) {
  const uint32_t u = (uint32_t)(p[0] | (p[1] << 8)) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// STEPS wgmma of a 128-byte slab, each 32 bytes deep, from step k0
template <int STEPS, class Acc, int N>
inline void mma_steps(Acc (&d)[N], const unsigned char* a,
                      const unsigned char* b, int k0, bool accumulate) {
  const int t = threadIdx.x % 128;
  Acc* acc = d;
  mma_open.push_back([=] {
    for (int kk = k0; kk < k0 + STEPS; ++kk) {
      for (int i = 0; i < N; ++i) {
        const int row = 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + 2 * (t % 4) + i % 2;
        Acc s = 0;
        const int step = std::is_same_v<Acc, int> ? 1 : 2;  // element bytes
        for (int e = 32 * kk; e < 32 * kk + 32; e += step) {
          if constexpr (std::is_same_v<Acc, int>)
            s += (int)(int8_t)*swizzled(a, row, e) *
                 (int)(int8_t)*swizzled(b, col, e);
          else
            s = std::fma(bf16_bits_at(swizzled(a, row, e)),
                         bf16_bits_at(swizzled(b, col, e)), s);
        }
        acc[i] = (accumulate || kk > k0) ? acc[i] + s : s;
      }
    }
  });
}
"""

BF16_STUB = r"""
#pragma once
#include <cstdint>
#include <cstring>
// bf16 as its 16 bits: the high half of an f32
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// round to nearest, ties to even (finite values)
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
"""

HARNESS = r"""
#include "cuda_runtime.h"
#include "assign.inc"
#include "update.inc"
#include "fused_step.inc"
#include <cstdio>
#include <cstdlib>
// harness m k n grid in out: in = x[m,n] c[k,n] ids[m];
// out = assign ids, d; update sums ++ counts; fused sums ++ counts ++ obj;
// update on the assignment's ids, sums ++ counts (`grid` is kernel A's
// grid and kernel C's order G)
// Kernel C's two launches (update.cuh) on ids, into out [k*n + k].
static void update_f32(const std::vector<float>& x, const int32_t* ids,
                       int64_t m, int k, int n, int G,
                       std::vector<float>& out) {
  const int64_t tiles = (m + TM - 1) / TM, slots = tiles * std::min(TM, k);
  std::vector<float> rec(slots * record_stride(n)), rc(slots);
  std::vector<int32_t> ix(tiles * k);
  launch2(tiles, tile_blocks<float>(n), TM, [&] {
    update_f32_tiles(x.data(), ids, rec.data(), rc.data(), ix.data(), m, k,
                     n, G);
  });
  launch2(k, reduce_blocks(n), RT, [&] {
    update_f32_reduce(reduce_buffer(tiles, n, m, k), rec.data(), rc.data(),
                      ix.data(), out.data(), k, n, tiles, G);
  });
}
int main(int argc, char** argv) {
  const int64_t m = atoll(argv[1]);
  const int k = atoi(argv[2]), n = atoi(argv[3]), grid = atoi(argv[4]);
  std::vector<float> x(m * n), c((size_t)k * n);
  std::vector<int32_t> ids(m);
  FILE* f = fopen(argv[5], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size() ||
      fread(c.data(), 4, c.size(), f) != c.size() ||
      fread(ids.data(), 4, ids.size(), f) != ids.size()) return 1;
  fclose(f);
  const int64_t tiles = (m + TM - 1) / TM;
  const int64_t su = (int64_t)k * n + k, sf = su + 1;
  std::vector<int32_t> aids(m);
  std::vector<float> ad(m), ou(su), pf(grid * sf), of(sf), oa(su);
  {  // kernel B through its entry point
    const int bn = k <= 32 ? 32 : 128, nt = (k + bn - 1) / bn;
    std::vector<float> csq(k), sbest(nt * m), xsq(m);
    std::vector<int32_t> sidx(nt * m);
    if (repro_assign_f32(x.data(), c.data(), csq.data(), sbest.data(),
                         sidx.data(), xsq.data(), aids.data(), ad.data(), m,
                         k, n, bn, grid, nullptr))
      return 2;
  }
  update_f32(x, ids.data(), m, k, n, grid, ou);
  launch(grid, TM, [&] { fused_step_f32_kernel(x.data(), c.data(), pf.data(),
                                               m, k, n, tiles); });
  launch(3, 256,
         [&] { fused_step_f32_reduce(pf.data(), of.data(), sf, grid); });
  update_f32(x, aids.data(), m, k, n, grid, oa);
  FILE* o = fopen(argv[6], "wb");
  fwrite(aids.data(), 4, m, o);
  fwrite(ad.data(), 4, m, o);
  fwrite(ou.data(), 4, su, o);
  fwrite(of.data(), 4, sf, o);
  fwrite(oa.data(), 4, su, o);
  fclose(o);
  return 0;
}
"""


HARNESS_BATCHED = r"""
#include "cuda_runtime.h"
#include "fused_step.inc"
#include "fused_step_batched.inc"
#include <cstdio>
#include <cstdlib>
// harness_batched B m k n grid in out: in = x[B,m,n] c[B,k,n];
// out = kernel D's [B, k*n + k + 1], then kernel A's on each stream
int main(int argc, char** argv) {
  const int B = atoi(argv[1]);
  const int64_t m = atoll(argv[2]);
  const int k = atoi(argv[3]), n = atoi(argv[4]), grid = atoi(argv[5]);
  std::vector<float> x(B * m * n), c((size_t)B * k * n);
  FILE* f = fopen(argv[6], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size() ||
      fread(c.data(), 4, c.size(), f) != c.size()) return 1;
  fclose(f);
  const int64_t tiles = (m + TM - 1) / TM;
  const int64_t sf = (int64_t)k * n + k + 1;
  std::vector<float> pd(B * grid * sf), od(B * sf), pa(grid * sf),
      oa(B * sf);
  launch2(grid, B, TM, [&] {
    fused_step_batched_f32_kernel(x.data(), c.data(), pd.data(), m, k, n,
                                  tiles);
  });
  launch2(2, B, 256, [&] {
    fused_step_batched_f32_reduce(pd.data(), od.data(), sf, grid);
  });
  for (int b = 0; b < B; ++b) {
    launch(grid, TM, [&] {
      fused_step_f32_kernel(x.data() + b * m * n, c.data() + b * k * n,
                            pa.data(), m, k, n, tiles);
    });
    launch(3, 256, [&] {
      fused_step_f32_reduce(pa.data(), oa.data() + b * sf, sf, grid);
    });
  }
  FILE* o = fopen(argv[7], "wb");
  fwrite(od.data(), 4, od.size(), o);
  fwrite(oa.data(), 4, oa.size(), o);
  fclose(o);
  return 0;
}
"""


HARNESS_INT8 = r"""
#include "cuda_runtime.h"
#include "assign_int8.inc"
#include "update_int8.inc"
#include "fused_step_int8.inc"
#include "fused_step_batched_int8.inc"
#include <cstdio>
#include <cstdlib>
// harness_int8 B m k n grid in out bn:
// in = xq[B,m,n] i8, cq[B,k,n] i8, scale[B,n], cf[B,k,n] f32, t[B,k],
// ids[m] i32
// out = csq[B,k] (sqnorm_rows on cf); B8 on stream 0 (ids, d; its entry
// point, bn centroids a tile, `grid` CTAs); C8 on
// stream 0 with ids (isums i32 ++ counts); A8 on each stream (isums i32 ++
// counts ++ obj); D8 (all streams' isums, then all streams' counts ++ obj)
template <typename T>
static bool get(FILE* f, std::vector<T>& v) {
  return fread(v.data(), sizeof(T), v.size(), f) == v.size();
}
template <typename T>
static void put(FILE* f, const std::vector<T>& v) {
  fwrite(v.data(), sizeof(T), v.size(), f);
}
int main(int argc, char** argv) {
  const int B = atoi(argv[1]);
  const int64_t m = atoll(argv[2]);
  const int k = atoi(argv[3]), n = atoi(argv[4]), grid = atoi(argv[5]);
  const int64_t kn = (int64_t)k * n;
  std::vector<int8_t> x(B * m * n), c(B * kn);
  std::vector<float> sc((size_t)B * n), cf(B * kn), csq((size_t)B * k),
      t((size_t)B * k);
  std::vector<int32_t> ids(m);
  FILE* f = fopen(argv[6], "rb");
  if (!get(f, x) || !get(f, c) || !get(f, sc) || !get(f, cf) || !get(f, t)
      || !get(f, ids)) return 1;
  fclose(f);
  const int64_t tiles = (m + TM - 1) / TM;
  FILE* o = fopen(argv[7], "wb");
  launch(sqnorm_grid(B * k, n), 256,
         [&] { sqnorm_rows(cf.data(), csq.data(), B * k, n); });
  put(o, csq);
  std::vector<int32_t> aids(m);
  std::vector<float> ad(m);
  {
    const int bn = atoi(argv[8]), nt = (k + bn - 1) / bn;
    std::vector<float> csq8(k), sbest((size_t)nt * m);
    std::vector<int32_t> sidx((size_t)nt * m);
    if (repro_assign_int8(x.data(), c.data(), cf.data(), csq8.data(),
                          t.data(), sc.data(), sbest.data(), sidx.data(),
                          aids.data(), ad.data(), m, k, n, bn, grid, nullptr))
      return 2;
  }
  put(o, aids);
  put(o, ad);
  std::vector<int32_t> ps(grid * kn), os(kn);
  std::vector<float> oc(k);
  {
    const int64_t slots = tiles * std::min(TM, k);
    std::vector<int32_t> rec(slots * record_stride(n)), ix(tiles * k);
    std::vector<float> rc(slots);
    launch2(tiles, tile_blocks<int8_t>(n), TM, [&] {
      update_int8_tiles(x.data(), ids.data(), rec.data(), rc.data(),
                        ix.data(), m, k, n, grid);
    });
    launch2(k, reduce_blocks(n), RT, [&] {
      update_int8_reduce(reduce_buffer(tiles, n, m, k), rec.data(), rc.data(),
                         ix.data(), os.data(), oc.data(), k, n, tiles, grid);
    });
  }
  put(o, os);
  put(o, oc);
  std::vector<float> pf(grid * (k + 1)), of(k + 1);
  for (int b = 0; b < B; ++b) {
    launch(grid, TM, [&] {
      fused_step_int8_kernel(x.data() + b * m * n, c.data() + b * kn,
                             csq.data() + b * k, t.data() + b * k,
                             sc.data() + b * n, ps.data(), pf.data(), m, k,
                             n, tiles);
    });
    launch(3, 256, [&] {
      fused_step_int8_reduce(ps.data(), pf.data(), os.data(), of.data(), kn,
                             k + 1, grid);
    });
    put(o, os);
    put(o, of);
  }
  std::vector<int32_t> pds(B * grid * kn), ods(B * kn);
  std::vector<float> pdf(B * grid * (k + 1)), odf(B * (k + 1));
  launch2(grid, B, TM, [&] {
    fused_step_batched_int8_kernel(x.data(), c.data(), csq.data(), t.data(),
                                   sc.data(), pds.data(), pdf.data(), m, k, n,
                                   tiles);
  });
  launch2(2, B, 256, [&] {
    fused_step_batched_int8_reduce(pds.data(), pdf.data(), ods.data(),
                                   odf.data(), kn, k + 1, grid);
  });
  put(o, ods);
  put(o, odf);
  fclose(o);
  return 0;
}
"""


HARNESS_16 = r"""
#include "cuda_runtime.h"
#include "assign_bf16.inc"
#include "update_bf16.inc"
#include "fused_step_bf16.inc"
#include "fused_step_batched_bf16.inc"
#include <cstdio>
#include <cstdlib>
// harness_16 B m k n grid in out bn:
// in = x[B,m,n] f32, xb[B,m,n] bf16, c[B,k,n] f32, ids[m] i32
// out = csq[B,k] (sqnorm_rows on c); then for bf16 (on xb) and bf16x3 (on
// x): B16/B3 on stream 0 (ids, d; B16 through its entry point, bn
// centroids a tile); C16/C3 on stream 0 with ids (sums ++
// counts); A16/A3 on each stream (sums ++ counts ++ obj); D16/D3 (all
// streams, each sums ++ counts ++ obj)
template <typename T>
static bool get(FILE* f, std::vector<T>& v) {
  return fread(v.data(), sizeof(T), v.size(), f) == v.size();
}
template <typename T>
static void put(FILE* f, const std::vector<T>& v) {
  fwrite(v.data(), sizeof(T), v.size(), f);
}
struct In {
  int B, k, n, grid, bn;
  int64_t m, tiles;
  std::vector<float> c, csq;
  std::vector<int32_t> ids;
};
template <typename X, typename A, typename U, typename F, typename D>
static void run(FILE* o, const In& in, const std::vector<X>& x, A assign,
                U update_k, F fused_k, D batched_k) {
  const int B = in.B, k = in.k, n = in.n, grid = in.grid;
  const int64_t m = in.m, tiles = in.tiles, kn = (int64_t)k * n;
  const int64_t su = kn + k, sf = su + 1;
  std::vector<int32_t> aids(m);
  std::vector<float> ad(m);
  assign(aids.data(), ad.data());
  put(o, aids);
  put(o, ad);
  std::vector<float> ou(su);
  {
    const int64_t slots = tiles * std::min(TM, k);
    std::vector<float> rec(slots * record_stride(n)), rc(slots);
    std::vector<int32_t> ix(tiles * k);
    launch2(tiles, tile_blocks<X>(n), TM, [&] {
      update_k(x.data(), in.ids.data(), rec.data(), rc.data(), ix.data(), m,
               k, n, grid);
    });
    launch2(k, reduce_blocks(n), RT, [&] {
      update_16_reduce(reduce_buffer(tiles, n, m, k), rec.data(), rc.data(),
                       ix.data(), ou.data(), k, n, tiles, grid);
    });
  }
  put(o, ou);
  std::vector<float> pf(grid * sf), of(sf);
  for (int b = 0; b < B; ++b) {
    launch(grid, TM, [&] {
      fused_k(x.data() + b * m * n, in.c.data() + b * kn,
              in.csq.data() + b * k, pf.data(), m, k, n, tiles);
    });
    launch(3, 256,
           [&] { fused_step_16_reduce(pf.data(), of.data(), sf, grid); });
    put(o, of);
  }
  std::vector<float> pd(B * grid * sf), od(B * sf);
  launch2(grid, B, TM, [&] {
    batched_k(x.data(), in.c.data(), in.csq.data(), pd.data(), m, k, n,
              tiles);
  });
  launch2(2, B, 256, [&] {
    fused_step_batched_16_reduce(pd.data(), od.data(), sf, grid);
  });
  put(o, od);
}
int main(int argc, char** argv) {
  In in;
  in.B = atoi(argv[1]);
  in.m = atoll(argv[2]);
  in.k = atoi(argv[3]);
  in.n = atoi(argv[4]);
  in.grid = atoi(argv[5]);
  in.bn = atoi(argv[8]);
  in.tiles = (in.m + TM - 1) / TM;
  const int64_t size = in.B * in.m * in.n;
  std::vector<float> x(size);
  std::vector<__nv_bfloat16> xb(size);
  in.c.resize((size_t)in.B * in.k * in.n);
  in.csq.resize((size_t)in.B * in.k);
  in.ids.resize(in.m);
  FILE* f = fopen(argv[6], "rb");
  if (!get(f, x) || !get(f, xb) || !get(f, in.c) || !get(f, in.ids)) return 1;
  fclose(f);
  FILE* o = fopen(argv[7], "wb");
  const int64_t rows = (int64_t)in.B * in.k;
  launch(sqnorm_grid(rows, in.n), 256,
         [&] { sqnorm_rows(in.c.data(), in.csq.data(), rows, in.n); });
  put(o, in.csq);
  const int nt = (in.k + in.bn - 1) / in.bn;
  std::vector<float> csq16(in.k), sbest((size_t)nt * in.m);
  std::vector<int32_t> sidx((size_t)nt * in.m);
  std::vector<__nv_bfloat16> cb((size_t)in.k * in.n);
  auto b16 = [&](int32_t* ids, float* d) {
    if (repro_assign_bf16(xb.data(), in.c.data(), csq16.data(), cb.data(),
                          sbest.data(), sidx.data(), ids, d, in.m, in.k,
                          in.n, in.bn, in.grid, nullptr))
      std::abort();
  };
  const int ld = (in.n + 7) / 8 * 8;       // B3's padded rows
  std::vector<__nv_bfloat16> xh(in.m * ld), xl(in.m * ld),
      ch((size_t)in.k * ld), cl((size_t)in.k * ld);
  std::vector<float> xsq(in.m);
  auto b3 = [&](int32_t* ids, float* d) {
    if (repro_assign_bf16x3(x.data(), in.c.data(), csq16.data(), xsq.data(),
                            xh.data(), xl.data(), ch.data(), cl.data(),
                            sbest.data(), sidx.data(), ids, d, in.m, in.k,
                            in.n, in.bn, in.grid, nullptr))
      std::abort();
  };
  run(o, in, xb, b16, update_bf16_tiles, fused_step_bf16_kernel,
      fused_step_batched_bf16_kernel);
  run(o, in, x, b3, update_bf16x3_tiles, fused_step_bf16x3_kernel,
      fused_step_batched_bf16x3_kernel);
  fclose(o);
  return 0;
}
"""


HARNESS_DMA = r"""
#include "cuda_runtime.h"
#include "fused_step.inc"
#include "fused_step_bf16.inc"
#include "fused_step_int8.inc"
#include "fused_step_dma.inc"
#include <cstdio>
#include <cstdlib>
// harness_dma m k n grid shift in out:
// in = x[m,n] f32, xb[m,n] bf16, xq[m,n] i8, c[k,n] f32, cq[k,n] i8,
// scale[n] f32, t[k] f32; x, xb and xq are read into their buffers
// `shift` elements in, so that (for bf16 and int8) rows need not start on
// a 4-byte word.
// out = for f32 (A on x), bf16 (A16 on xb), bf16x3 (A3 on x): the blocks
// kernel's [k*n + k + 1], then its dma twin's; for int8 (A8 on xq): the
// blocks kernel's isums [k*n] i32 ++ counts ++ obj, then its dma twin's
template <typename T>
static bool get(FILE* f, T* p, size_t n) {
  return fread(p, sizeof(T), n, f) == n;
}
template <typename T>
static void put(FILE* f, const std::vector<T>& v) {
  fwrite(v.data(), sizeof(T), v.size(), f);
}
int main(int argc, char** argv) {
  const int64_t m = atoll(argv[1]);
  const int k = atoi(argv[2]), n = atoi(argv[3]), grid = atoi(argv[4]);
  const int shift = atoi(argv[5]);
  const int64_t mn = m * n, kn = (int64_t)k * n, sf = kn + k + 1;
  std::vector<float> xbuf(mn + 4), c(kn), scale(n), t(k), csq(k);
  std::vector<__nv_bfloat16> xbbuf(mn + 4);
  std::vector<int8_t> xqbuf(mn + 4), cq(kn);
  float* x = xbuf.data() + shift;
  __nv_bfloat16* xb = xbbuf.data() + shift;
  int8_t* xq = xqbuf.data() + shift;
  FILE* f = fopen(argv[6], "rb");
  if (!get(f, x, mn) || !get(f, xb, mn) || !get(f, xq, mn) ||
      !get(f, c.data(), kn) || !get(f, cq.data(), kn) ||
      !get(f, scale.data(), n) || !get(f, t.data(), k)) return 1;
  fclose(f);
  const int64_t tiles = (m + TM - 1) / TM;
  FILE* o = fopen(argv[7], "wb");
  launch(sqnorm_grid(k, n), 256,
         [&] { sqnorm_rows(c.data(), csq.data(), k, n); });
  std::vector<float> pf(grid * sf), of(sf);
  auto reduce16 = [&] {
    launch(3, 256, [&] { fused_step_16_reduce(pf.data(), of.data(), sf, grid); });
    put(o, of);
  };
  launch(grid, TM, [&] {
    fused_step_f32_kernel(x, c.data(), pf.data(), m, k, n, tiles);
  });
  launch(3, 256, [&] { fused_step_f32_reduce(pf.data(), of.data(), sf, grid); });
  put(o, of);
  launch(grid, TM, [&] {
    fused_step_f32_dma_kernel(x, c.data(), pf.data(), m, k, n, tiles);
  });
  launch(3, 256, [&] { fused_step_dma_reduce(pf.data(), of.data(), sf, grid); });
  put(o, of);
  launch(grid, TM, [&] {
    fused_step_bf16_kernel(xb, c.data(), csq.data(), pf.data(), m, k, n, tiles);
  });
  reduce16();
  launch(grid, TM, [&] {
    fused_step_bf16_dma_kernel(xb, c.data(), csq.data(), pf.data(), m, k, n,
                               tiles);
  });
  reduce16();
  launch(grid, TM, [&] {
    fused_step_bf16x3_kernel(x, c.data(), csq.data(), pf.data(), m, k, n,
                             tiles);
  });
  reduce16();
  launch(grid, TM, [&] {
    fused_step_bf16x3_dma_kernel(x, c.data(), csq.data(), pf.data(), m, k, n,
                                 tiles);
  });
  reduce16();
  std::vector<int32_t> ps(grid * kn), os(kn);
  std::vector<float> pq(grid * (k + 1)), oq(k + 1);
  launch(grid, TM, [&] {
    fused_step_int8_kernel(xq, cq.data(), csq.data(), t.data(), scale.data(),
                           ps.data(), pq.data(), m, k, n, tiles);
  });
  launch(3, 256, [&] {
    fused_step_int8_reduce(ps.data(), pq.data(), os.data(), oq.data(), kn,
                           k + 1, grid);
  });
  put(o, os);
  put(o, oq);
  launch(grid, TM, [&] {
    fused_step_int8_dma_kernel(xq, cq.data(), csq.data(), t.data(),
                               scale.data(), ps.data(), pq.data(), m, k, n,
                               tiles);
  });
  launch(3, 256, [&] {
    fused_step_int8_dma_reduce(ps.data(), pq.data(), os.data(), oq.data(), kn,
                               k + 1, grid);
  });
  put(o, os);
  put(o, oq);
  fclose(o);
  return 0;
}
"""


HARNESS_KPP = r"""
#include "cuda_runtime.h"
#include "kpp_probe.inc"
#include <cstdio>
#include <cstdlib>
// harness_kpp m L n grid ct shift in out: in = x[m,n], cands[L,n], d[m]
// (f32); x and d start `shift` floats past a 16-byte boundary of their
// buffers, with slack around them; ct: the candidate tile (0: the entry
// point's, from L).  out = newd [m,L] ++ pot [L] ++ the ticket after the
// launch (int32), twice (two launches).  The ticket starts at zero (the
// caller's) and the second launch takes it as the first left it.
static float* placed(std::vector<float>& buf, int64_t count, int shift) {
  buf.assign(count + 16 + shift, 0.f);
  const uintptr_t a = (reinterpret_cast<uintptr_t>(buf.data()) + 15) & ~15;
  return reinterpret_cast<float*>(a) + 4 + shift;
}
int main(int argc, char** argv) {
  const int64_t m = atoll(argv[1]);
  const int L = atoi(argv[2]), n = atoi(argv[3]), grid = atoi(argv[4]);
  const int ct = atoi(argv[5]), shift = atoi(argv[6]);
  std::vector<float> xb, db, c((size_t)L * n), newd(m * L), part(grid * L),
      pot(L);
  float* x = placed(xb, m * n, shift);
  float* d = placed(db, m, shift);
  FILE* f = fopen(argv[7], "rb");
  if (fread(x, 4, m * n, f) != (size_t)(m * n) ||
      fread(c.data(), 4, c.size(), f) != c.size() ||
      fread(d, 4, m, f) != (size_t)m) return 1;
  fclose(f);
  int ticket = 0;
  FILE* o = fopen(argv[8], "wb");
  for (int rep = 0; rep < 2; ++rep) {
    int err;
    if (ct == 0) {
      err = repro_kpp_probe(x, c.data(), d, newd.data(), part.data(),
                            pot.data(), &ticket, m, L, n, grid, nullptr);
    } else {
      const repro::KppArgs a{x, c.data(), d, newd.data(), part.data(),
                             pot.data(), &ticket, m, L, n,
                             (m + repro::TM - 1) / repro::TM};
      err = repro::kpp_launch(a, grid, ct, nullptr);
    }
    if (err) return 2;
    fwrite(newd.data(), 4, newd.size(), o);
    fwrite(pot.data(), 4, pot.size(), o);
    fwrite(&ticket, 4, 1, o);
  }
  fclose(o);
  return 0;
}
"""


HARNESS_DRAW = r"""
#include "cuda_runtime.h"
#include "kpp_draw.inc"
#include <cstdio>
#include <cstdlib>
// harness_draw s L n grid mode in out: in = x[s,n], noise[L,s], d[s],
// newd[s,L], pot[L], cands[L,n] (f32).  mode 0: the first slot (no
// previous probe); 1: a slot after a probe (newd, pot); 2: the pick alone
// (no noise).  out = d [s] ++ c_row [n] ++ cands [L,n] ++ idx [L] (int64)
// ++ the ticket after the launch (int32).  The ticket starts at zero (the
// caller's), c_row and idx at garbage.
int main(int argc, char** argv) {
  const int64_t s = atoll(argv[1]);
  const int L = atoi(argv[2]), n = atoi(argv[3]), grid = atoi(argv[4]);
  const int mode = atoi(argv[5]);
  std::vector<float> x(s * n), noise((size_t)L * s), d(s), newd(s * L),
      pot(L), cands((size_t)L * n), c_row(n, -7.f), pv(grid * L * 2);
  std::vector<int> pi(grid * (L * 2 + 1));
  std::vector<int64_t> idx(L, -5);
  FILE* f = fopen(argv[6], "rb");
  if (fread(x.data(), 4, x.size(), f) != x.size() ||
      fread(noise.data(), 4, noise.size(), f) != noise.size() ||
      fread(d.data(), 4, d.size(), f) != d.size() ||
      fread(newd.data(), 4, newd.size(), f) != newd.size() ||
      fread(pot.data(), 4, pot.size(), f) != pot.size() ||
      fread(cands.data(), 4, cands.size(), f) != cands.size()) return 1;
  fclose(f);
  int ticket = 0;
  const int err = repro_kpp_draw(
      x.data(), mode == 2 ? nullptr : noise.data(), d.data(),
      mode == 0 ? nullptr : newd.data(), mode == 0 ? nullptr : pot.data(),
      mode == 0 ? nullptr : c_row.data(), cands.data(), idx.data(),
      pv.data(), pi.data(), &ticket, s, L, n, grid, nullptr);
  if (err) return 2;
  FILE* o = fopen(argv[7], "wb");
  fwrite(d.data(), 4, d.size(), o);
  fwrite(c_row.data(), 4, c_row.size(), o);
  fwrite(cands.data(), 4, cands.size(), o);
  fwrite(idx.data(), 8, idx.size(), o);
  fwrite(&ticket, 4, 1, o);
  fclose(o);
  return 0;
}
"""


HARNESS_UPDATE = r"""
#include "cuda_runtime.h"
#include "update.inc"
#include "update_bf16.inc"
#include "update_int8.inc"
#include <cstdio>
#include <cstdlib>
#include <type_traits>
// harness_update m k n G shift in out [entries]:
// in = x[m,n] f32, xb[m,n] bf16, xq[m,n] i8, ids[m] i32; x, xb and xq are
// read into their buffers `shift` elements in (rows off 16 bytes, bf16 and
// int8 rows off the word).
// out = C (on x), C16 (on xb), C3 (on x): sums ++ counts [k*n + k] f32;
// C8 (on xq): isums [k*n] i32 ++ counts [k] f32.  G: the reduce's order;
// entries (if given and > 0): the reduce's buffer holds that many entries
// (else the launchers' reduce_buffer), so that a cluster's list takes
// several batches.
static int room_entries = 0;
template <typename T>
static bool get(FILE* f, T* p, size_t n) {
  return fread(p, sizeof(T), n, f) == n;
}
// The tile pass and the reduce of one kernel; S the sums' type.  Kernels
// C, C16 and C3 reduce into one buffer, sums ++ counts; C8 into two.
template <typename S, typename X, typename Tiles, typename Reduce>
static void run(FILE* o, Tiles tiles_k, Reduce reduce_k, const X* x,
                const int32_t* ids, int64_t m, int k, int n, int G) {
  const int64_t tiles = (m + TM - 1) / TM, kn = (int64_t)k * n;
  const int64_t slots = tiles * std::min(TM, k);
  std::vector<S> rec(slots * record_stride(n)), os(kn + k);
  std::vector<float> rc(slots), oc(k);
  std::vector<int32_t> ix(tiles * k);
  launch2(tiles, tile_blocks<X>(n), TM, [&] {
    tiles_k(x, ids, rec.data(), rc.data(), ix.data(), m, k, n, G);
  });
  const int room = room_entries > 0
                       ? room_entries * record_stride(std::min(n, RT))
                       : reduce_buffer(tiles, n, m, k);
  launch2(k, reduce_blocks(n), RT, [&] {
    if constexpr (std::is_same_v<S, int32_t>)
      reduce_k(room, rec.data(), rc.data(), ix.data(), os.data(), oc.data(),
               k, n, tiles, G);
    else
      reduce_k(room, rec.data(), rc.data(), ix.data(), os.data(), k, n,
               tiles, G);
  });
  fwrite(os.data(), sizeof(S), kn, o);
  if constexpr (std::is_same_v<S, int32_t>)
    fwrite(oc.data(), 4, k, o);
  else
    fwrite(os.data() + kn, 4, k, o);
}
int main(int argc, char** argv) {
  const int64_t m = atoll(argv[1]);
  const int k = atoi(argv[2]), n = atoi(argv[3]), G = atoi(argv[4]);
  const int shift = atoi(argv[5]);
  if (argc > 8) room_entries = atoi(argv[8]);
  const int64_t mn = m * n;
  std::vector<float> xbuf(mn + 4);
  std::vector<__nv_bfloat16> xbbuf(mn + 4);
  std::vector<int8_t> xqbuf(mn + 4);
  std::vector<int32_t> ids(m);
  float* x = xbuf.data() + shift;
  __nv_bfloat16* xb = xbbuf.data() + shift;
  int8_t* xq = xqbuf.data() + shift;
  FILE* f = fopen(argv[6], "rb");
  if (!get(f, x, mn) || !get(f, xb, mn) || !get(f, xq, mn) ||
      !get(f, ids.data(), m)) return 1;
  fclose(f);
  FILE* o = fopen(argv[7], "wb");
  run<float>(o, update_f32_tiles, update_f32_reduce, x, ids.data(), m, k, n,
             G);
  run<float>(o, update_bf16_tiles, update_16_reduce, xb, ids.data(), m, k, n,
             G);
  run<float>(o, update_bf16x3_tiles, update_16_reduce, x, ids.data(), m, k,
             n, G);
  run<int32_t>(o, update_int8_tiles, update_int8_reduce, xq, ids.data(), m,
               k, n, G);
  fclose(o);
  return 0;
}
"""


HARNESS_MMA = r"""
#include "cuda_runtime.h"
#include "assign_int8.inc"
#include "assign_bf16.inc"
#include <cstdio>
#include <cstdlib>
// harness_mma m k n bn grid shift in out:
// in = xq[m,n] i8, scale[n] f32, cq[k,n] i8, t[k] f32, c[k,n] f32,
// xb[m,n] bf16; xq and xb are read into their buffers `shift` elements in
// (a base off 16 bytes: the byte-load path).
// out = B8's ids [m] i32 and d [m] f32, then B16's, through their entry
// points with bn centroids a tile on `grid` persistent CTAs
template <typename T>
static bool get(FILE* f, T* p, size_t n) {
  return fread(p, sizeof(T), n, f) == n;
}
int main(int argc, char** argv) {
  const int64_t m = atoll(argv[1]);
  const int k = atoi(argv[2]), n = atoi(argv[3]), bn = atoi(argv[4]);
  const int grid = atoi(argv[5]), shift = atoi(argv[6]);
  const int64_t mn = m * n, kn = (int64_t)k * n, nt = (k + bn - 1) / bn;
  std::vector<int8_t> xqbuf(mn + 16), cq(kn);
  std::vector<__nv_bfloat16> xbbuf(mn + 16), cb(kn);
  std::vector<float> sc(n), t(k), c(kn), csq(k), sbest(nt * m), d(m);
  std::vector<int32_t> sidx(nt * m), ids(m);
  int8_t* xq = xqbuf.data() + shift;
  __nv_bfloat16* xb = xbbuf.data() + shift;
  FILE* f = fopen(argv[7], "rb");
  if (!get(f, xq, mn) || !get(f, sc.data(), n) || !get(f, cq.data(), kn) ||
      !get(f, t.data(), k) || !get(f, c.data(), kn) || !get(f, xb, mn))
    return 1;
  fclose(f);
  FILE* o = fopen(argv[8], "wb");
  if (repro_assign_int8(xq, cq.data(), c.data(), csq.data(), t.data(),
                        sc.data(), sbest.data(), sidx.data(), ids.data(),
                        d.data(), m, k, n, bn, grid, nullptr))
    return 2;
  fwrite(ids.data(), 4, m, o);
  fwrite(d.data(), 4, m, o);
  if (repro_assign_bf16(xb, c.data(), csq.data(), cb.data(), sbest.data(),
                        sidx.data(), ids.data(), d.data(), m, k, n, bn, grid,
                        nullptr))
    return 3;
  fwrite(ids.data(), 4, m, o);
  fwrite(d.data(), 4, m, o);
  fclose(o);
  return 0;
}
"""


HARNESS_B = r"""
#include "cuda_runtime.h"
#include "assign.inc"
#include "assign_bf16.inc"
#include <cstdio>
#include <cstdlib>
// harness_b m k n grid shift in out: in = x[m,n] f32, c[k,n] f32; x is
// read into its buffer `shift` elements in (a base off 16 bytes).
// out = kernel B's ids [m] i32 and d [m] f32 through its entry point (bn 32
// or 128 centroids a tile on `grid` persistent CTAs), then the CUDA-core
// body B had before (common.cuh:assign_cta under F32Ops, `grid` CTAs),
// then B3's through its entry point (bn 64 or 128)
template <typename T>
static bool get(FILE* f, T* p, size_t n) {
  return fread(p, sizeof(T), n, f) == n;
}
int main(int argc, char** argv) {
  const int64_t m = atoll(argv[1]);
  const int k = atoi(argv[2]), n = atoi(argv[3]), grid = atoi(argv[4]);
  const int shift = atoi(argv[5]);
  const int64_t mn = m * n, kn = (int64_t)k * n;
  std::vector<float> xbuf(mn + 16), c(kn), csq(k), xsq(m), d(m);
  std::vector<int32_t> ids(m);
  float* x = xbuf.data() + shift;
  FILE* f = fopen(argv[6], "rb");
  if (!get(f, x, mn) || !get(f, c.data(), kn)) return 1;
  fclose(f);
  FILE* o = fopen(argv[7], "wb");
  const int bn = k <= 32 ? 32 : 128, nt = (k + bn - 1) / bn;
  std::vector<float> sbest(2 * nt * m);
  std::vector<int32_t> sidx(2 * nt * m);
  if (repro_assign_f32(x, c.data(), csq.data(), sbest.data(), sidx.data(),
                       xsq.data(), ids.data(), d.data(), m, k, n, bn, grid,
                       nullptr))
    return 2;
  fwrite(ids.data(), 4, m, o);
  fwrite(d.data(), 4, m, o);
  const int64_t tiles = (m + TM - 1) / TM;
  launch(grid, TM, [&] {
    __shared__ TileSmem s;
    assign_cta(s, x, c.data(), ids.data(), d.data(), m, k, n, tiles);
  });
  fwrite(ids.data(), 4, m, o);
  fwrite(d.data(), 4, m, o);
  const int bn3 = k <= 64 ? 64 : 128, ld = (n + 7) / 8 * 8;
  std::vector<__nv_bfloat16> xh(m * ld), xl(m * ld), ch((size_t)k * ld),
      cl((size_t)k * ld);
  if (repro_assign_bf16x3(x, c.data(), csq.data(), xsq.data(), xh.data(),
                          xl.data(), ch.data(), cl.data(), sbest.data(),
                          sidx.data(), ids.data(), d.data(), m, k, n, bn3,
                          grid, nullptr))
    return 3;
  fwrite(ids.data(), 4, m, o);
  fwrite(d.data(), 4, m, o);
  fclose(o);
  return 0;
}
"""


HARNESS_ONEHOT = r"""
#include "cuda_runtime.h"
#include "fused_step.inc"
#include "fused_step_bf16.inc"
#include "fused_step_int8.inc"
#include "fused_step_batched.inc"
#include "fused_step_batched_bf16.inc"
#include "fused_step_batched_int8.inc"
#include "fused_step_dma.inc"
#include "onehot.cuh"
#include <cstdio>
#include <cstdlib>
// harness_onehot B m k n grid shift in out:
// in = x[B,m,n] f32, xb[B,m,n] bf16, xq[B,m,n] i8, c[B,k,n] f32,
// cq[B,k,n] i8, scale[B,n] f32, t[B,k] f32; x, xb and xq are read into
// their buffers `shift` elements in (every kernel reads them there).
// out = for f32 (on x), bf16 (xb), bf16x3 (x), int8 (xq): per stream b the
// parent's body (onehot.cuh, kernel A's grid and reduce), kernel A (A8,
// A16, A3) and kernel D's stream b, then A's dma twin on stream 0; each
// [k*n + k + 1] words (int8: isums i32 ++ counts ++ obj).  Every partial
// buffer starts as 0x7F bytes, so a partial never written shows.
template <typename T>
static bool get(FILE* f, T* p, size_t n) {
  return fread(p, sizeof(T), n, f) == n;
}
template <typename T>
static void put(FILE* f, const std::vector<T>& v) {
  fwrite(v.data(), sizeof(T), v.size(), f);
}
template <typename T>
static void garbage(std::vector<T>& v) {
  std::memset(v.data(), 0x7F, v.size() * sizeof(T));
}
template <class Ops>
static void parent_float(const typename Ops::X* x, const float* c,
                         const float* csq, float* part, int64_t m, int k,
                         int n, int64_t tiles) {
  __shared__ TileSmemT<Ops> s;
  const int64_t stride = (int64_t)k * n + k + 1;
  fused_cta_onehot(s, x, c, part + blockIdx.x * stride, m, k, n, tiles, csq);
}
static void parent_int8(const int8_t* x, const int8_t* c, const float* csq,
                        const float* tq, const float* scale, int32_t* psum,
                        float* pf, int64_t m, int k, int n, int64_t tiles) {
  __shared__ TileSmemQ s;
  const int64_t kn = (int64_t)k * n;
  fused_cta_q_onehot(s, x, c, csq, tq, scale, psum + blockIdx.x * kn,
                     pf + blockIdx.x * ((int64_t)k + 1), m, k, n, tiles);
}
int main(int argc, char** argv) {
  const int B = atoi(argv[1]);
  const int64_t m = atoll(argv[2]);
  const int k = atoi(argv[3]), n = atoi(argv[4]), grid = atoi(argv[5]);
  const int shift = atoi(argv[6]);
  const int64_t mn = m * n, kn = (int64_t)k * n, sf = kn + k + 1;
  std::vector<float> xbuf(B * mn + 4), c(B * kn), scale((size_t)B * n),
      t((size_t)B * k), csq((size_t)B * k);
  std::vector<__nv_bfloat16> xbbuf(B * mn + 4);
  std::vector<int8_t> xqbuf(B * mn + 4), cq(B * kn);
  float* x = xbuf.data() + shift;
  __nv_bfloat16* xb = xbbuf.data() + shift;
  int8_t* xq = xqbuf.data() + shift;
  FILE* f = fopen(argv[7], "rb");
  if (!get(f, x, B * mn) || !get(f, xb, B * mn) || !get(f, xq, B * mn) ||
      !get(f, c.data(), B * kn) || !get(f, cq.data(), B * kn) ||
      !get(f, scale.data(), B * n) || !get(f, t.data(), B * k)) return 1;
  fclose(f);
  const int64_t tiles = (m + TM - 1) / TM;
  launch(sqnorm_grid(B * k, n), 256,
         [&] { sqnorm_rows(c.data(), csq.data(), B * k, n); });
  FILE* o = fopen(argv[8], "wb");
  std::vector<float> pf(grid * sf), of(sf), pd(B * grid * sf), od(B * sf);
  // one float policy: kernel(x_b, c_b, csq_b, part) runs a launch of A's
  // body (the parent's or this one) on stream b
  auto floats = [&](auto parent, auto a_kernel, auto d_kernel, auto dma,
                    auto reduce, auto d_reduce, auto x_of) {
    auto run = [&](auto body, int b) {
      garbage(pf);
      launch(grid, TM, [&] { body(x_of(b), c.data() + b * kn,
                                  csq.data() + b * k, pf.data(), m, k, n,
                                  tiles); });
      launch(3, 256, [&] { reduce(pf.data(), of.data(), sf, grid); });
      put(o, of);
    };
    garbage(pd);
    launch2(grid, B, TM, [&] { d_kernel(x_of(0), c.data(), csq.data(),
                                        pd.data(), m, k, n, tiles); });
    launch2(2, B, 256, [&] { d_reduce(pd.data(), od.data(), sf, grid); });
    for (int b = 0; b < B; ++b) {
      run(parent, b);
      run(a_kernel, b);
      fwrite(od.data() + b * sf, 4, sf, o);
    }
    run(dma, 0);
  };
  auto xf = [&](int b) { return x + b * mn; };
  auto xbf = [&](int b) { return xb + b * mn; };
  floats(parent_float<F32Ops>,
         [](const float* x, const float* c, const float*, float* part,
            int64_t m, int k, int n, int64_t tiles) {
           fused_step_f32_kernel(x, c, part, m, k, n, tiles);
         },
         [](const float* x, const float* c, const float*, float* part,
            int64_t m, int k, int n, int64_t tiles) {
           fused_step_batched_f32_kernel(x, c, part, m, k, n, tiles);
         },
         [](const float* x, const float* c, const float*, float* part,
            int64_t m, int k, int n, int64_t tiles) {
           fused_step_f32_dma_kernel(x, c, part, m, k, n, tiles);
         },
         fused_step_f32_reduce, fused_step_batched_f32_reduce, xf);
  floats(parent_float<Bf16Ops>, fused_step_bf16_kernel,
         fused_step_batched_bf16_kernel, fused_step_bf16_dma_kernel,
         fused_step_16_reduce, fused_step_batched_16_reduce, xbf);
  floats(parent_float<Bf16x3Ops>, fused_step_bf16x3_kernel,
         fused_step_batched_bf16x3_kernel, fused_step_bf16x3_dma_kernel,
         fused_step_16_reduce, fused_step_batched_16_reduce, xf);
  // int8: isums and counts ++ obj, each launch's partials garbage first
  std::vector<int32_t> ps(grid * kn), os(kn), pds(B * grid * kn), ods(B * kn);
  std::vector<float> pq(grid * (k + 1)), oq(k + 1), pdq(B * grid * (k + 1)),
      odq(B * (k + 1));
  garbage(pds);
  garbage(pdq);
  launch2(grid, B, TM, [&] {
    fused_step_batched_int8_kernel(xq, cq.data(), csq.data(), t.data(),
                                   scale.data(), pds.data(), pdq.data(), m,
                                   k, n, tiles);
  });
  launch2(2, B, 256, [&] {
    fused_step_batched_int8_reduce(pds.data(), pdq.data(), ods.data(),
                                   odq.data(), kn, k + 1, grid);
  });
  auto int8_run = [&](auto body, int b) {
    garbage(ps);
    garbage(pq);
    launch(grid, TM, [&] {
      body(xq + b * mn, cq.data() + b * kn, csq.data() + b * k,
           t.data() + b * k, scale.data() + b * n, ps.data(), pq.data(), m,
           k, n, tiles);
    });
    launch(3, 256, [&] {
      fused_step_int8_reduce(ps.data(), pq.data(), os.data(), oq.data(), kn,
                             k + 1, grid);
    });
    put(o, os);
    put(o, oq);
  };
  for (int b = 0; b < B; ++b) {
    int8_run(parent_int8, b);
    int8_run(fused_step_int8_kernel, b);
    fwrite(ods.data() + b * kn, 4, kn, o);
    fwrite(odq.data() + b * (k + 1), 4, k + 1, o);
  }
  int8_run(fused_step_int8_dma_kernel, 0);
  fclose(o);
  return 0;
}
"""


HARNESSES = ("harness", "harness_batched", "harness_int8", "harness_16",
             "harness_dma", "harness_kpp", "harness_draw", "harness_update",
             "harness_mma",
             "harness_b", "harness_onehot")


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the kernels")
    d = tmp_path_factory.mktemp("csrc")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "cuda_bf16.h").write_text(BF16_STUB)
    (d / "harness.cpp").write_text(HARNESS)
    for name in build.SOURCES:
        src = (build.CSRC / name).read_text()
        # a launch becomes a plain call; the harness launches the kernels
        (d / Path(name).with_suffix(".inc")).write_text(
            re.sub(r"<<<[^>]*>>>", "", src))
    (d / "harness_batched.cpp").write_text(HARNESS_BATCHED)
    (d / "harness_int8.cpp").write_text(HARNESS_INT8)
    (d / "harness_16.cpp").write_text(HARNESS_16)
    (d / "harness_dma.cpp").write_text(HARNESS_DMA)
    (d / "harness_kpp.cpp").write_text(HARNESS_KPP)
    (d / "harness_draw.cpp").write_text(HARNESS_DRAW)
    (d / "harness_update.cpp").write_text(HARNESS_UPDATE)
    (d / "harness_mma.cpp").write_text(HARNESS_MMA)
    (d / "harness_b.cpp").write_text(HARNESS_B)
    (d / "harness_onehot.cpp").write_text(HARNESS_ONEHOT)
    procs = [subprocess.Popen(
        [cxx, "-std=c++20", "-O1", "-pthread", f"-I{d}", f"-I{build.CSRC}",
         str(d / f"{name}.cpp"), "-o", str(d / name)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in HARNESSES]
    for proc in procs:
        _, err = proc.communicate()
        assert proc.returncode == 0, err
    return d / "harness"


SHAPES = [  # (m, k, n, grid): ragged tiles, CTAs with several tiles,
    (600, 25, 28, 2),      # k and n tiles with ragged edges, a single
    (300, 40, 3, 1),       # cluster, and n > 32 (x reloaded per phase)
    (513, 70, 68, 2),
    (100, 33, 40, 1),
    (257, 1, 5, 3),
]


def run_f32(harness, tmp_path, shape):
    """Blobs at ``shape`` through the f32 harness (see HARNESS): returns
    (x, c, pids, pd, ids, outputs) with ids the plain assignment with
    padding and out-of-range ids put in, outputs (B's ids, B's d, C on
    ids, A, C on B's ids)."""
    m, k, n, grid = shape
    rng = np.random.default_rng(m + k)
    c = (rng.normal(size=(k, n)) * 5).astype(np.float32)
    x = (c[rng.integers(0, k, m)] + rng.normal(size=(m, n))).astype(
        np.float32)
    if k > 1:
        c[-1] = c[0]                     # twin centroids: exact score ties
    X, C = torch.from_numpy(x), torch.from_numpy(c)
    pids, pd = ref.assign_ref(X, C)
    ids = pids.numpy().copy()
    ids[::7] = -1                        # padding: never hits
    ids[3::11] = k                       # out of range: adds nothing
    ids[5::13] = k + 40
    (tmp_path / "in.bin").write_bytes(x.tobytes() + c.tobytes()
                                      + ids.tobytes())
    subprocess.run([str(harness), str(m), str(k), str(n), str(grid),
                    str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=120)
    out = np.fromfile(tmp_path / "out.bin", dtype=np.uint8)
    kn = k * n
    sizes = [4 * m, 4 * m, 4 * (kn + k), 4 * (kn + k + 1), 4 * (kn + k)]
    aids, ad, ou, of, oa = (out[a:b] for a, b in
                            zip(np.cumsum([0] + sizes[:-1]),
                                np.cumsum(sizes)))
    outs = (aids.view(np.int32), ad.view(np.float32), ou.view(np.float32),
            of.view(np.float32), oa.view(np.float32))
    return x, c, pids, pd, ids, outs


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"m{m}-k{k}-n{n}-g{g}" for m, k, n, g in SHAPES])
def test_kernel_sources_match_plain(harness, tmp_path, shape):
    m, k, n, grid = shape
    x, c, pids, pd, ids, (aids, ad, ou, of, _) = run_f32(harness, tmp_path,
                                                          shape)
    X = torch.from_numpy(x)
    kn = k * n

    np.testing.assert_array_equal(aids, pids.numpy())
    if k > 1:
        assert not np.any(aids == k - 1)  # a tie goes to the lowest index
    scale = (np.sqrt((x.astype(np.float64) ** 2).sum(1))
             + np.sqrt((c.astype(np.float64) ** 2).sum(1))[aids]) ** 2
    assert np.all(np.abs(ad - pd.numpy()) <= RTOL * scale)

    for (sums, counts), used in (((ou[:kn], ou[kn:]), ids),
                                 ((of[:kn], of[kn:kn + k]), pids.numpy())):
        want_s, want_c = ref.update_ref(X, torch.from_numpy(used), k)
        np.testing.assert_array_equal(counts, want_c.numpy())
        abs_s, _ = ref.update_ref(X.abs(), torch.from_numpy(used), k)
        assert np.all(np.abs(sums - want_s.numpy().ravel())
                      <= RTOL * abs_s.numpy().ravel() + 1e-6)
    np.testing.assert_allclose(of[-1], float(pd.sum()), rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"m{m}-k{k}-n{n}-g{g}" for m, k, n, g in SHAPES])
def test_update_source_bitwise_kernel_a_on_its_ids(harness, tmp_path, shape):
    """Kernel C on kernel A's own assignment (kernel B's ids: the same
    argmin code) gives bitwise A's sums and counts when C's order G is A's
    grid: both add each tile's rows in row order, then the tiles of CTA
    g, then the CTAs in order."""
    m, k, n, _ = shape
    _, _, _, _, _, (aids, _, _, of, oa) = run_f32(harness, tmp_path, shape)
    kn = k * n
    np.testing.assert_array_equal(oa.view(np.uint32),
                                  of[:kn + k].view(np.uint32))
    assert np.all((aids >= 0) & (aids < k))


UPDATE_CASES = [  # (m, k, n, shift, ids, G[, batch]): each order G on several
    (600, 25, 28, 0, "padded", 1),     # cases; a ragged last tile, ids -1
    (600, 25, 28, 0, "padded", 2),     # and >= k, rows of -0.0; one
    (600, 25, 28, 0, "padded", 3),     # cluster in every tile, CTAs of
    (1100, 4, 5, 1, "one", 2),         # several tiles; a tile of 256
    (1100, 4, 5, 1, "one", 3),         # distinct ids, k > 256; n = 3, 37
    (600, 300, 7, 0, "distinct", 1),   # and 1,100 (feature blocks under
    (600, 300, 7, 0, "distinct", 2),   # every policy), rows off the word
    (300, 40, 3, 3, "padded", 1),      # and off 16 bytes; G > tiles; m
    (300, 40, 3, 3, "padded", 3),      # smaller than one tile
    (513, 33, 37, 1, "padded", 2),
    (513, 33, 37, 1, "padded", 3),
    (300, 20, 1100, 0, "padded", 2),
    (100, 10, 9, 2, "padded", 1),
    (100, 10, 9, 2, "padded", 3),
    (1100, 4, 5, 1, "one", 2, 1),      # the reduce's lists in batches of
    (600, 25, 28, 0, "padded", 3, 2),  # 1 and 2 entries
]


def update_inputs(m, k, n, kind, seed):
    """x [m,n] f32 with rows of -0.0 (one cluster has nothing else), and
    ids of the pattern ``kind``: 'padded' (ids -1, k and k + 40 among
    them), 'one' (cluster 0 in every tile) or 'distinct' (tile 0 holds 256
    distinct ids)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, n)) * 3).astype(np.float32)
    ids = rng.integers(0, k, m).astype(np.int32)
    if kind == "padded":
        ids[::7] = -1
        ids[3::11] = k
        ids[5::13] = k + 40
    elif kind == "one":
        ids[rng.uniform(size=m) < 0.8] = 0
    else:
        ids[:min(m, 256)] = rng.permutation(k)[:min(m, 256)]
    x[ids == 1] = -0.0                   # a cluster of -0.0 rows only
    x[2::17] = -0.0
    return x, ids


@pytest.mark.parametrize("case", UPDATE_CASES, ids=[
    f"m{m}-k{k}-n{n}-s{sh}-{kind}-G{G}" + "".join(f"-b{b}" for b in rest)
    for m, k, n, sh, kind, G, *rest in UPDATE_CASES])
def test_update_sources_bitwise_parent_order(harness, tmp_path, case):
    """Kernels C, C16, C3 and C8 (the sorted scatter) bitwise the one-hot
    kernels they replaced, whose association ``parent_order_update``
    replays in numpy: sums, counts and int32 sums, for orders G = 1, 2,
    3, and with the reduce's lists cut into batches of 1 and 2 entries."""
    m, k, n, shift, kind, G, *batch = case
    x, ids = update_inputs(m, k, n, kind, seed=m + k + n + G)
    X = torch.from_numpy(x)
    xb = X.bfloat16()
    qx = px.quantize_chunk(X)
    (tmp_path / "in.bin").write_bytes(
        x.tobytes() + xb.view(torch.int16).numpy().tobytes()
        + qx.q.numpy().tobytes() + ids.tobytes())
    subprocess.run([str(harness.parent / "harness_update"), str(m), str(k),
                    str(n), str(G), str(shift), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin"), *map(str, batch)],
                   check=True, timeout=300)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.uint32)
    kn = k * n
    assert raw.size == 4 * (kn + k)
    wants = (parent_order_update(x, ids, k, G),
             parent_order_update(xb.float().numpy(), ids, k, G),
             parent_order_update(x, ids, k, G, split=True),
             parent_order_update(qx.q.numpy(), ids, k, G))
    for i, (name, (sums, counts)) in enumerate(zip(("C", "C16", "C3", "C8"),
                                                   wants)):
        got = raw[i * (kn + k):(i + 1) * (kn + k)]
        want = sums.astype(np.int32 if name == "C8" else np.float32)
        np.testing.assert_array_equal(got[:kn], want.ravel().view(np.uint32),
                                      err_msg=name)
        np.testing.assert_array_equal(got[kn:], counts.view(np.uint32),
                                      err_msg=name)
    # the oracle is the plain update up to the order of the float sums
    ok = (ids >= 0) & (ids < k)
    np.testing.assert_array_equal(wants[3][0], int_sums(qx.q.numpy(), ids, k))
    np.testing.assert_array_equal(wants[0][1], np.bincount(
        ids[ok], minlength=k).astype(np.float32))
    assert np.all(np.abs(wants[0][0] - ref.update_ref(
        X, torch.from_numpy(ids), k)[0].numpy()) <= sums_bound(x, ids, k))


BATCHED_SHAPES = [  # (B, m, k, n, grid): kernel D, stream by stream
    (3, 600, 25, 28, 2),   # the main path's k and n, two tiles per CTA
    (2, 257, 1, 3, 3),     # k = 1, n = 3, a CTA without a full tile
    (2, 300, 33, 40, 1),   # k not a multiple of 32, n > 32
]


@pytest.mark.parametrize("shape", BATCHED_SHAPES, ids=[
    f"B{b}-m{m}-k{k}-n{n}-g{g}" for b, m, k, n, g in BATCHED_SHAPES])
def test_batched_kernel_source_matches_plain_and_kernel_a(harness, tmp_path,
                                                          shape):
    B, m, k, n, grid = shape
    rng = np.random.default_rng(B * m + k)
    c = (rng.normal(size=(B, k, n)) * 5).astype(np.float32)
    x = np.stack([c[b][rng.integers(0, k, m)] for b in range(B)])
    x = (x + rng.normal(size=x.shape)).astype(np.float32)
    (tmp_path / "in.bin").write_bytes(x.tobytes() + c.tobytes())
    subprocess.run([str(harness.parent / "harness_batched"), str(B), str(m),
                    str(k), str(n), str(grid), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=120)
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32)
    stride = k * n + k + 1
    d_out, a_out = out[:B * stride], out[B * stride:]
    # every stream of D is bitwise kernel A on that stream
    np.testing.assert_array_equal(d_out.view(np.uint32),
                                  a_out.view(np.uint32))
    X, C = torch.from_numpy(x), torch.from_numpy(c)
    sums, counts, obj = fused_step.fused_step_batched_plain(X, C)
    d_out = d_out.reshape(B, stride)
    kn = k * n
    np.testing.assert_array_equal(d_out[:, kn:kn + k], counts.numpy())
    np.testing.assert_allclose(d_out[:, -1], obj.numpy(), rtol=RTOL)
    for b in range(B):
        ids, _ = ref.assign_ref(X[b], C[b])
        abs_s, _ = ref.update_ref(X[b].abs(), ids, k)
        assert np.all(np.abs(d_out[b, :kn] - sums[b].numpy().ravel())
                      <= RTOL * abs_s.numpy().ravel() + 1e-6), b


# --------------------------------------------------------------------------
# int8 kernels A8, B8, C8, D8
# --------------------------------------------------------------------------


def run_int8(harness, tmp_path, x, c, ids, grid):
    """Quantize x [B,m,n] and c [B,k,n] as the wrappers do, run the int8
    harness and split its output (see HARNESS_INT8)."""
    B, m, n = x.shape
    k = c.shape[1]
    qx = px.quantize_chunk(torch.from_numpy(x))
    C = torch.from_numpy(c)
    cq, t = px.quantize_centroids(C, qx.scale)
    (tmp_path / "in.bin").write_bytes(b"".join(
        a.numpy().tobytes() for a in (qx.q, cq, qx.scale, C, t))
        + ids.tobytes())
    subprocess.run([str(harness.parent / "harness_int8"), str(B), str(m),
                    str(k), str(n), str(grid), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin"), str(distance.mma_n_tile(k))],
                   check=True, timeout=120)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.uint8)
    kn = k * n
    layout = ([("csq", np.float32, B * k),
               ("ids", np.int32, m), ("d", np.float32, m),
               ("c8_sums", np.int32, kn), ("c8_counts", np.float32, k)]
              + [row for b in range(B) for row in
                 ((f"a8_sums_{b}", np.int32, kn),
                  (f"a8_cf_{b}", np.float32, k + 1))]
              + [("d8_sums", np.int32, B * kn),
                 ("d8_cf", np.float32, B * (k + 1))])
    out, at = {}, 0
    for name, dtype, size in layout:
        out[name] = raw[at:at + 4 * size].view(dtype)
        at += 4 * size
    assert at == raw.size
    return qx, out


def int_sums(q, ids, k):
    """Exact per-cluster sums of the codes (int64), ids outside [0, k)
    dropped."""
    sums = np.zeros((k, q.shape[1]), np.int64)
    ok = (ids >= 0) & (ids < k)
    np.add.at(sums, ids[ok], q[ok].astype(np.int64))
    return sums


INT8_SHAPES = [  # (B, m, k, n, grid): ragged tiles, CTAs with several
    (2, 600, 25, 28, 2),   # tiles, k and n tiles with ragged edges, n > 32
    (1, 300, 40, 3, 1),    # (codes reloaded per phase), k = 1, a CTA
    (2, 513, 70, 68, 2),   # without a tile
    (3, 257, 1, 5, 3),
]


@pytest.mark.parametrize("data", ["blobs", "exact"])
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=[
    f"B{b}-m{m}-k{k}-n{n}-g{g}" for b, m, k, n, g in INT8_SHAPES])
def test_int8_kernel_sources_match_plain(harness, tmp_path, shape, data):
    """Kernels A8, B8, C8, D8 against the plain int8 versions.

    Tolerances: the centroid norms of the first launch, B8's ids and d,
    int32 sums and counts bitwise (norms added in the plain version's
    order, scores rounded as it rounds them, sums exact integers); on the
    exact blobs everything bitwise (every value an integer below 2**24);
    on float blobs the objective within ``RTOL`` of the plain version (its
    rows summed in another order); D8's stream b bitwise A8 on stream b.
    """
    B, m, k, n, grid = shape
    if data == "exact":
        pairs = [int8_exact_blobs(m, n, k, seed=b + 3) for b in range(B)]
    else:
        rng = np.random.default_rng(m + k)
        pairs = []
        for _ in range(B):
            c = (rng.normal(size=(k, n)) * 5).astype(np.float32)
            x = c[rng.integers(0, k, m)] + rng.normal(size=(m, n))
            pairs.append((x.astype(np.float32), c))
    x = np.stack([p[0] for p in pairs])
    c = np.stack([p[1] for p in pairs])
    X0, C0 = torch.from_numpy(x[0]), torch.from_numpy(c[0])
    pids, pd = ref.assign_ref(X0, C0, precision="int8")
    ids = pids.numpy().copy()
    ids[::7] = -1                        # padding: never hits
    ids[3::11] = k                       # out of range: adds nothing
    qx, out = run_int8(harness, tmp_path, x, c, ids, grid)
    q0 = qx.q[0].numpy()
    scale = qx.scale.numpy()

    # the norms' first launch: features in order, as the plain version
    np.testing.assert_array_equal(
        out["csq"], px.sqnorm_in_order(torch.from_numpy(c)).numpy().ravel())
    # B8: ids and d
    np.testing.assert_array_equal(out["ids"], pids.numpy())
    np.testing.assert_array_equal(out["d"], pd.numpy())
    # C8: int32 sums exact given the ids, counts exact
    np.testing.assert_array_equal(out["c8_sums"].reshape(k, n),
                                  int_sums(q0, ids, k))
    want_s, want_c = ref.update_ref(
        px.QuantizedChunk(qx.q[0], qx.scale[0]), torch.from_numpy(ids), k,
        precision="int8")
    np.testing.assert_array_equal(out["c8_counts"], want_c.numpy())
    got_s = torch.from_numpy(out["c8_sums"]).float().view(k, n) \
        * qx.scale[0][None, :]
    assert torch.equal(got_s, want_s)    # scaled after the full reduce

    for b in range(B):
        a_sums, a_cf = out[f"a8_sums_{b}"], out[f"a8_cf_{b}"]
        qb = px.QuantizedChunk(qx.q[b], qx.scale[b])
        bids, bd = ref.assign_ref(qb, torch.from_numpy(c[b]),
                                  precision="int8")
        np.testing.assert_array_equal(a_sums.reshape(k, n),
                                      int_sums(qx.q[b].numpy(),
                                               bids.numpy(), k))
        sums_p, counts_p, obj_p = fused_step.fused_step_int8_plain(
            qb, torch.from_numpy(c[b]))
        np.testing.assert_array_equal(a_cf[:k], counts_p.numpy())
        got = torch.from_numpy(a_sums).float().view(k, n) \
            * qx.scale[b][None, :]
        assert torch.equal(got, sums_p)
        if data == "exact":
            assert float(a_cf[k]) == float(obj_p)
        else:
            np.testing.assert_allclose(a_cf[k], float(obj_p), rtol=RTOL)
        # D8's stream b is bitwise A8 on stream b
        np.testing.assert_array_equal(out["d8_sums"][b * k * n:
                                                     (b + 1) * k * n],
                                      a_sums)
        np.testing.assert_array_equal(
            out["d8_cf"][b * (k + 1):(b + 1) * (k + 1)].view(np.uint32),
            a_cf.view(np.uint32))
    assert scale.shape == (B, n)


# --------------------------------------------------------------------------
# bf16 and bf16x3 kernels A16, B16, C16, D16 and A3, B3, C3, D3
# --------------------------------------------------------------------------


def run_16(harness, tmp_path, x, c, ids, grid):
    """Run the bf16 / bf16x3 harness on x [B,m,n], c [B,k,n] and split its
    output (see HARNESS_16): {"csq": ..., "bf16": {...}, "bf16x3": {...}}."""
    B, m, n = x.shape
    k = c.shape[1]
    xb = torch.from_numpy(x).bfloat16().view(torch.int16).numpy()
    (tmp_path / "in.bin").write_bytes(x.tobytes() + xb.tobytes()
                                      + c.tobytes() + ids.tobytes())
    subprocess.run([str(harness.parent / "harness_16"), str(B), str(m),
                    str(k), str(n), str(grid), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin"), str(distance.mma_n_tile(k))],
                   check=True, timeout=300)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.uint8)
    kn = k * n
    per = ([("ids", np.int32, m), ("d", np.float32, m),
            ("update", np.float32, kn + k)]
           + [(f"fused_{b}", np.float32, kn + k + 1) for b in range(B)]
           + [("batched", np.float32, B * (kn + k + 1))])
    layout = [("csq", np.float32, B * k)] + [
        ((p, name), dtype, size) for p in ("bf16", "bf16x3")
        for name, dtype, size in per]
    out, at = {"bf16": {}, "bf16x3": {}}, 0
    for name, dtype, size in layout:
        part = raw[at:at + 4 * size].view(dtype)
        if isinstance(name, tuple):
            out[name[0]][name[1]] = part
        else:
            out[name] = part
        at += 4 * size
    assert at == raw.size
    return out


def near_ties_16(x, c, precision):
    """Rows whose best two scores ||c||^2 - 2 dot(x, c) under the policy
    (x in its storage) are within 1e-4 relative."""
    xs = px.cast_storage(x, precision)
    scores = px.sqnorm(c)[None, :] - 2.0 * px.dot(xs, c, ([1], [1]),
                                                   precision)
    if scores.shape[1] < 2:
        return torch.zeros(scores.shape[0], dtype=torch.bool)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= 1e-4 * two[:, 0].abs()


BF16_SHAPES = [  # (B, m, k, n, grid): ragged tiles, CTAs with several
    (2, 600, 25, 28, 2),   # tiles, k and n tiles with ragged edges, n > 32
    (1, 300, 40, 3, 1),    # (x reloaded per phase), k = 1, a CTA without
    (2, 513, 70, 68, 2),   # a tile
    (3, 257, 1, 5, 3),
]


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=[
    f"B{b}-m{m}-k{k}-n{n}-g{g}" for b, m, k, n, g in BF16_SHAPES])
def test_bf16_kernel_sources_match_plain(harness, tmp_path, shape):
    """Kernels A16/A3, B16/B3, C16/C3 and D16/D3 against the plain versions
    at their policy (x cast to its storage first).

    Tolerances: the centroid norms of the first launch bitwise (features in
    order, as ``sqnorm_in_order``); ids equal off near ties (none on these
    blobs) and a twin centroid never chosen (ties go to the lowest index);
    d within RTOL of the terms' magnitude (norms and dots summed in another
    order; bf16 products are exact in f32, so only the order differs);
    counts exact; sums within RTOL of the cluster's sum of |x|; the
    objective within RTOL; D's stream b bitwise A's on stream b.
    """
    B, m, k, n, grid = shape
    rng = np.random.default_rng(m + k + 1)
    c = (rng.normal(size=(B, k, n)) * 5).astype(np.float32)
    if k > 1:
        c[:, -1] = c[:, 0]               # twin centroids: exact score ties
    x = np.stack([c[b][rng.integers(0, k, m)] for b in range(B)])
    x = (x + rng.normal(size=x.shape)).astype(np.float32)
    X, C = torch.from_numpy(x), torch.from_numpy(c)
    ids = distance.assign_plain(X[0], C[0], "bf16")[0].numpy().copy()
    ids[::7] = -1                        # padding: never hits
    ids[3::11] = k                       # out of range: adds nothing
    out = run_16(harness, tmp_path, x, c, ids, grid)
    np.testing.assert_array_equal(
        out["csq"], px.sqnorm_in_order(C).numpy().ravel())
    kn = k * n
    for prec in ("bf16", "bf16x3"):
        got = out[prec]
        xs0 = px.cast_storage(X[0], prec).float().numpy()
        pids, pd = distance.assign_plain(X[0], C[0], prec)
        ties = near_ties_16(X[0], C[0][:max(k - 1, 1)], prec).numpy()
        assert ties.sum() <= 2
        np.testing.assert_array_equal(got["ids"][~ties], pids.numpy()[~ties])
        if k > 1:
            assert not np.any(got["ids"] == k - 1), prec
        bound = (np.sqrt((xs0.astype(np.float64) ** 2).sum(1))
                 + np.sqrt((c[0].astype(np.float64) ** 2).sum(1))[
                     pids.numpy()]) ** 2
        assert np.all(np.abs(got["d"] - pd.numpy()) <= RTOL * bound), prec

        usums, ucounts = update.update_plain(X[0], torch.from_numpy(ids), k,
                                             prec)
        abs_u, _ = ref.update_ref(torch.from_numpy(np.abs(xs0)),
                                  torch.from_numpy(ids), k)
        np.testing.assert_array_equal(got["update"][kn:], ucounts.numpy())
        assert np.all(np.abs(got["update"][:kn] - usums.numpy().ravel())
                      <= RTOL * abs_u.numpy().ravel() + 1e-6), prec

        for b in range(B):
            a_out = got[f"fused_{b}"]
            sums_p, counts_p, obj_p = fused_step.fused_step_plain(X[b], C[b],
                                                                  prec)
            bids, _ = distance.assign_plain(X[b], C[b], prec)
            xsb = px.cast_storage(X[b], prec).float().abs()
            abs_s, _ = ref.update_ref(xsb, bids, k)
            np.testing.assert_array_equal(a_out[kn:kn + k], counts_p.numpy())
            assert np.all(np.abs(a_out[:kn] - sums_p.numpy().ravel())
                          <= RTOL * abs_s.numpy().ravel() + 1e-6), (prec, b)
            np.testing.assert_allclose(a_out[-1], float(obj_p), rtol=RTOL)
            # D's stream b is bitwise A's on stream b
            np.testing.assert_array_equal(
                got["batched"][b * (kn + k + 1):(b + 1) * (kn + k + 1)]
                .view(np.uint32), a_out.view(np.uint32))


# --------------------------------------------------------------------------
# the dma kernels A-dma, A16-dma, A3-dma, A8-dma against their blocks twins
# --------------------------------------------------------------------------

DMA_SHAPES = [  # (m, k, n, grid, shift): a CTA with two tiles (the next
    (600, 25, 28, 2, 0),   # tile's slab copied ahead), a ragged last tile,
    (600, 25, 28, 2, 1),   # n = 3 (rows of 6 and 3 bytes: bf16 and int8
    (300, 40, 3, 1, 3),    # segments off the word), n > 32 with several k
    (513, 70, 68, 2, 1),   # and feature tiles (slabs per step, in kernel
    (257, 33, 37, 3, 1),   # A's order), odd n > 32, k = 1, a CTA without
    (100, 1, 5, 1, 2),     # a tile, x's base `shift` elements off its
]                          # buffer's


@pytest.mark.parametrize("shape", DMA_SHAPES, ids=[
    f"m{m}-k{k}-n{n}-g{g}-s{sh}" for m, k, n, g, sh in DMA_SHAPES])
def test_dma_kernel_sources_bitwise_blocks(harness, tmp_path, shape):
    """Each dma kernel's slot logic gives bitwise its blocks twin's
    outputs under every policy (the deferred-copy stand-in shows a slab
    read before its wait or a slot overwritten while read), and the blocks
    twins' counts equal the plain versions' (both ran)."""
    m, k, n, grid, shift = shape
    rng = np.random.default_rng(m + k + n)
    c = (rng.normal(size=(k, n)) * 5).astype(np.float32)
    x = (c[rng.integers(0, k, m)] + rng.normal(size=(m, n))).astype(
        np.float32)
    X, C = torch.from_numpy(x), torch.from_numpy(c)
    xb = X.bfloat16().view(torch.int16).numpy()
    qx = px.quantize_chunk(X)
    cq, t = px.quantize_centroids(C, qx.scale)
    (tmp_path / "in.bin").write_bytes(b"".join(
        a.tobytes() for a in (x, xb, qx.q.numpy(), c, cq.numpy(),
                              qx.scale.numpy(), t.numpy())))
    subprocess.run([str(harness.parent / "harness_dma"), str(m), str(k),
                    str(n), str(grid), str(shift), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=300)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.uint32)
    kn, sf = k * n, k * n + k + 1
    assert raw.size == 6 * sf + 2 * (kn + k + 1)
    for i, prec in enumerate(("f32", "bf16", "bf16x3")):
        blocks = raw[2 * i * sf:(2 * i + 1) * sf]
        dma = raw[(2 * i + 1) * sf:(2 * i + 2) * sf]
        np.testing.assert_array_equal(dma, blocks, err_msg=prec)
        counts = blocks[kn:kn + k].view(np.float32)
        _, want, _ = fused_step.fused_step_plain(X, C, prec)
        np.testing.assert_array_equal(counts, want.numpy(), err_msg=prec)
    q8 = raw[6 * sf:]
    np.testing.assert_array_equal(q8[sf:], q8[:sf], err_msg="int8")
    _, want, _ = fused_step.fused_step_int8_plain(qx, C)
    np.testing.assert_array_equal(q8[kn:kn + k].view(np.float32),
                                  want.numpy())


# --------------------------------------------------------------------------
# kernel P (kpp_probe)
# --------------------------------------------------------------------------

KPP_SHAPES = [  # (m, L, n, grid, base shift): the reference test's small
    (100, 3, 7, 1, 0),     # shapes, n > 32 (feature tiles), L > 32
    (513, 3, 28, 2, 0),    # (candidate tiles), CTAs with two tiles and a
    (300, 8, 70, 1, 0),    # ragged last one;
    (600, 40, 68, 2, 0),
    (300, 1, 28, 2, 0),    # L around every candidate-tile boundary (4, 8,
    (300, 4, 28, 2, 0),    # 32: 4 dots a row for L <= 4, 8 for L <= 8,
    (300, 5, 28, 2, 0),    # else 32 a candidate tile);
    (300, 8, 13, 2, 0),
    (300, 9, 12, 2, 0),
    (300, 33, 20, 1, 0),
    (260, 128, 28, 1, 0),
    (513, 3, 28, 2, 1),    # x and d one element off a 16-byte boundary;
    (300, 5, 70, 2, 1),    # the same with feature tiles;
    (1000, 3, 28, 1, 0),   # one CTA walking four tiles, the ring (3 stages)
    (600, 3, 68, 1, 0),    # wrapping, ragged last tile; 9 slabs over a
    (300, 3, 28, 4, 0),    # 4-stage ring; more CTAs than tiles
]


def kpp_inputs(m, L, n):
    """Standard normal x and candidates, d uniform in [0, 4n): the
    distances are about 2n, so about half the rows take a candidate's
    distance and half keep d (below 5, as the reference test draws d, every
    row would keep it and the dots would not show)."""
    rng = np.random.default_rng(m + L)
    x = rng.normal(size=(m, n)).astype(np.float32)
    c = rng.normal(size=(L, n)).astype(np.float32)
    d = (rng.uniform(size=m) * 4.0 * n).astype(np.float32)
    return x, c, d


def run_kpp(harness, tmp_path, x, c, d, grid, ct=0, shift=0):
    """Kernel P through the stand-in, launched twice: returns (newd, pot,
    ticket) of each launch."""
    (m, n), L = x.shape, c.shape[0]
    (tmp_path / "in.bin").write_bytes(x.tobytes() + c.tobytes() + d.tobytes())
    subprocess.run([str(harness.parent / "harness_kpp"), str(m), str(L),
                    str(n), str(grid), str(ct), str(shift),
                    str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32)
    one = m * L + L + 1
    assert out.size == 2 * one
    return [(out[k:k + m * L].reshape(m, L), out[k + m * L:k + one - 1],
             int(out[k + one - 1:k + one].view(np.int32)[0]))
            for k in (0, one)]


@pytest.mark.parametrize("shape", KPP_SHAPES, ids=[
    f"m{m}-L{L}-n{n}-g{g}" + (f"-off{s}" if s else "")
    for m, L, n, g, s in KPP_SHAPES])
def test_kpp_probe_source_matches_plain(harness, tmp_path, shape):
    """Kernel P against ``kpp_probe_plain``.  Tolerances: newd within
    ``RTOL`` of the magnitude of its terms, (||x|| + ||c||)^2 (norms and
    dots summed in another order); pot within ``RTOL``; two launches
    bitwise equal, the second from the ticket the first left, the ticket
    back at 0 after each."""
    m, L, n, grid, shift = shape
    x, c, d = kpp_inputs(m, L, n)
    (newd, pot, ticket), again = run_kpp(harness, tmp_path, x, c, d, grid,
                                         shift=shift)
    np.testing.assert_array_equal(newd.view(np.uint32),
                                  again[0].view(np.uint32))
    np.testing.assert_array_equal(pot.view(np.uint32),
                                  again[1].view(np.uint32))
    assert ticket == 0 and again[2] == 0
    want_newd, want_pot = kpp_probe_plain(torch.from_numpy(x),
                                          torch.from_numpy(c),
                                          torch.from_numpy(d))
    bound = np.stack([d_bound(x, c, np.full(m, j)) for j in range(L)], 1)
    assert np.all(np.abs(newd - want_newd.numpy()) <= bound)
    np.testing.assert_allclose(pot, want_pot.numpy(), rtol=RTOL)


@pytest.mark.parametrize("n", [28, 68])
def test_kpp_probe_newd_bitwise_across_grids_and_tiles(harness, tmp_path, n):
    """A row's newd depends only on its FMA order over the features: the
    same bits whatever grid and candidate tile compute it (L = 3 at tiles
    4, 8 and 32; one, three and five CTAs); pot within ``RTOL`` of the
    entry point's."""
    m, L = 700, 3
    x, c, d = kpp_inputs(m, L, n)
    runs = [run_kpp(harness, tmp_path, x, c, d, grid, ct)[0]
            for grid, ct in ((1, 0), (3, 8), (5, 32), (2, 4))]
    for newd, pot, _ in runs[1:]:
        np.testing.assert_array_equal(newd.view(np.uint32),
                                      runs[0][0].view(np.uint32))
        np.testing.assert_allclose(pot, runs[0][1], rtol=RTOL)


# --------------------------------------------------------------------------
# kernel G (kpp_draw): a K-means++ slot's D² draw and the previous pick
# --------------------------------------------------------------------------

DRAW_CASES = [  # (s, L, n, data): every CTA of several grids, ragged
    (1000, 3, 7, "gauss"),     # ranges, L at 1 and at P's 128, rows of one
    (777, 1, 28, "gauss"),     # feature; all distances 0 (uniform draw);
    (600, 128, 3, "gauss"),    # exact ties of the best entry within a
    (900, 3, 1, "zeros"),      # thread, across threads and across CTAs
    (1500, 3, 5, "ties"),      # (the first index wins); a NaN (it wins,
    (800, 4, 6, "nan"),        # first of two)
]


def draw_inputs(s, L, n, data):
    """x, Gumbel noise [L, s], d >= 0 (a tenth of it 0), the previous
    slot's newd [s, L] and pot [L] (a tie for the least at 0 and L - 1),
    and its candidates [L, n]."""
    rng = np.random.default_rng(s + L)
    x = rng.normal(size=(s, n)).astype(np.float32)
    noise = rng.gumbel(size=(L, s)).astype(np.float32)
    d = (rng.uniform(size=s) * 9.0).astype(np.float32)
    d[rng.integers(0, s, s // 10)] = 0.0
    if data == "zeros":
        d[:] = 0.0
    if data in ("ties", "nan"):
        for l in range(L):
            logits = np.log(np.maximum(d, 1e-30))
            best = int(np.argmax(noise[l] + logits))
            # the same entry at a later row: in this thread, another
            # thread, another CTA
            for i in (best + 256, best + 1, s - 1 - l):
                if best < i < s:
                    noise[l, i], d[i] = noise[l, best], d[best]
    if data == "nan":
        noise[0, s // 3] = noise[0, s // 2] = np.nan
    newd = (rng.uniform(size=(s, L)) * 9.0).astype(np.float32)
    pot = rng.uniform(1.0, 2.0, size=L).astype(np.float32)
    pot[0] = pot[-1] = 0.5
    cands = rng.normal(size=(L, n)).astype(np.float32)
    return x, noise, d, newd, pot, cands


def run_draw(harness, tmp_path, inputs, grid, mode):
    """Kernel G through the stand-in: (d, c_row, cands, idx, ticket)."""
    x, noise, d, newd, pot, cands = inputs
    (s, n), L = x.shape, noise.shape[0]
    (tmp_path / "in.bin").write_bytes(b"".join(
        a.tobytes() for a in inputs))
    subprocess.run([str(harness.parent / "harness_draw"), str(s), str(L),
                    str(n), str(grid), str(mode), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", dtype=np.uint8)
    sizes = [4 * s, 4 * n, 4 * L * n, 8 * L, 4]
    d, c_row, cands, idx, ticket = (out[a:b] for a, b in zip(
        np.cumsum([0] + sizes[:-1]), np.cumsum(sizes)))
    return (d.view(np.float32), c_row.view(np.float32),
            cands.view(np.float32).reshape(L, n), idx.view(np.int64),
            int(ticket.view(np.int32)[0]))


def draw_oracle(x, noise, d):
    """The oracle chain's draw (``kmeanspp._seed``), in torch on the CPU:
    (idx, x[idx])."""
    d = torch.from_numpy(d)
    logits = torch.where(torch.sum(d) > 0,
                         torch.log(torch.clamp_min(d, 1e-30)),
                         torch.zeros_like(d))
    idx = torch.argmax(torch.from_numpy(noise) + logits[None, :], dim=1)
    return idx.numpy(), x[idx.numpy()]


@pytest.mark.parametrize("case", DRAW_CASES, ids=[
    f"s{s}-L{L}-n{n}-{data}" for s, L, n, data in DRAW_CASES])
def test_kpp_draw_source_matches_the_oracle_chain(harness, tmp_path, case):
    """Kernel G at one, three and seven CTAs: with no previous probe, the
    oracle chain's candidates from d; after one, the pick b = argmin pot
    (first of a tie), d rewritten as newd[:, b], the previous candidate
    cands[b] in the centroid row, then the oracle chain's candidates from
    the new d; with no noise the pick alone.  Bitwise, whatever the grid,
    and the ticket back at 0."""
    inputs = draw_inputs(*case)
    x, noise, d, newd, pot, cands = inputs
    want_idx, want_cands = draw_oracle(x, noise, d)
    b = int(torch.argmin(torch.from_numpy(pot)))
    assert b == 0
    want_idx1, want_cands1 = draw_oracle(x, noise, newd[:, b].copy())
    for grid in (1, 3, 7):
        got_d, _, got_cands, got_idx, ticket = run_draw(
            harness, tmp_path, inputs, grid, 0)
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got_cands, want_cands)
        np.testing.assert_array_equal(got_d.view(np.uint32), d.view(np.uint32))
        assert ticket == 0
        got_d, c_row, got_cands, got_idx, ticket = run_draw(
            harness, tmp_path, inputs, grid, 1)
        np.testing.assert_array_equal(got_d.view(np.uint32),
                                      newd[:, b].view(np.uint32))
        np.testing.assert_array_equal(c_row, cands[b])
        np.testing.assert_array_equal(got_idx, want_idx1)
        np.testing.assert_array_equal(got_cands, want_cands1)
        assert ticket == 0
    got_d, c_row, got_cands, got_idx, ticket = run_draw(
        harness, tmp_path, inputs, 1, 2)
    np.testing.assert_array_equal(c_row, cands[b])
    np.testing.assert_array_equal(got_cands, cands)
    np.testing.assert_array_equal(got_d, d)
    assert ticket == 0


# --------------------------------------------------------------------------
# kernels B8 and B16 on the tensor cores (csrc/assign_mma.cuh)
# --------------------------------------------------------------------------

MMA_CASES = [  # (m, k, n, bn, grid, shift, data)
    (300, 25, 28, 64, 2, 0, "blobs"),     # the main path's k and n: rows
    (300, 25, 28, 128, 1, 1, "blobs"),    # off 16 bytes; bn 128, 103 padded
    (257, 25, 3, 64, 3, 0, "blobs"),      # columns; n = 3; a CTA with no
    (200, 130, 68, 128, 2, 1, "blobs"),   # tile; k = 130, 300 (two and
    (200, 130, 68, 64, 3, 0, "ties"),     # three centroid tiles, the last
    (130, 300, 1024, 128, 2, 0, "ties"),  # ragged); n = 1,024 by 16-byte
    (130, 300, 1024, 128, 1, 3, "blobs"),  # copies and by bytes; exact
    (200, 130, 28, 128, 2, 0, "far"),     # ties across a tile boundary;
    (70, 40, 1100, 64, 1, 1, "blobs"),    # every real score above 0; n
]                                         # past 1,024: two window levels


def mma_inputs(m, k, n, bn, data, seed):
    """(x, c): blobs; 'ties': twin centroids across centroid tiles (j and
    j + bn for j = 0, 3, k - bn - 1) and within one (0 and 1, 2 and 8),
    the first rows at each twin;
    'far': points near 0 and centroids far away, so that every real score
    ||c||^2 - 2 x.c is above 0, where a padded column (zero codes, no
    norm) would score 0."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(k, n)) * 5).astype(np.float32)
    if data == "ties":
        for j in (0, 3, k - bn - 1):
            c[j + bn] = c[j]
        c[1] = c[0]                      # one lane's two columns
        c[8] = c[2]                      # two lanes of a quad
    comp = rng.integers(0, k, m)
    if data == "ties":                   # the first rows at each twin
        comp[:8] = [0, bn, 3, bn + 3, k - bn - 1, k - 1, 1, 8]
    x = c[comp] + rng.normal(size=(m, n))
    if data == "far":
        c += 40.0
        x = rng.normal(size=(m, n))
    return x.astype(np.float32), c


@pytest.mark.parametrize("case", MMA_CASES, ids=[
    f"m{m}-k{k}-n{n}-bn{bn}-g{g}-s{sh}-{data}"
    for m, k, n, bn, g, sh, data in MMA_CASES])
def test_mma_assign_sources_match_plain(harness, tmp_path, case):
    """Kernels B8 and B16 (wgmma products emulated on the card's fragment
    layout through the 128-byte swizzle, held to their waits) against the
    plain versions.

    B8: ids bitwise the first minimum of its scores ``csq - 2 float(xq.cq)
    t`` (the plain version's arithmetic; exact int32 dots), equal to the
    plain ids off near ties, and d bitwise the plain d.  B16: ids equal to
    the plain ids off near ties, d within RTOL of its terms' magnitude (f32
    sums of exact bf16 products in another order).  Both: a twin never
    chosen over the lower twin, across a centroid tile or within one; no
    id past k (padded columns never win)."""
    m, k, n, bn, grid, shift, data = case
    x, c = mma_inputs(m, k, n, bn, data, seed=m + k + n)
    X, C = torch.from_numpy(x), torch.from_numpy(c)
    qx = px.quantize_chunk(X)
    cq, t = px.quantize_centroids(C, qx.scale)
    xb = X.bfloat16().view(torch.int16).numpy()
    (tmp_path / "in.bin").write_bytes(b"".join(
        a.tobytes() for a in (qx.q.numpy(), qx.scale.numpy(), cq.numpy(),
                              t.numpy(), c, xb)))
    subprocess.run([str(harness.parent / "harness_mma"), str(m), str(k),
                    str(n), str(bn), str(grid), str(shift),
                    str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=300)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.int32)
    assert raw.size == 4 * m
    ids8, d8, ids16, d16 = (raw[i * m:(i + 1) * m] for i in range(4))
    d8, d16 = d8.view(np.float32), d16.view(np.float32)

    scores = (px.sqnorm_in_order(C)[None, :]
              - 2.0 * (px.intdot(qx.q, cq, ([1], [1])).float() * t[None, :]))
    np.testing.assert_array_equal(ids8, torch.argmin(scores, 1).numpy())
    pids, pd = distance.assign_int8_plain(qx, C)
    ties8 = near_ties_int8(qx, C).numpy()
    np.testing.assert_array_equal(ids8[~ties8], pids.numpy()[~ties8])
    np.testing.assert_array_equal(d8.view(np.uint32),
                                  pd.numpy().view(np.uint32))

    pids16, pd16 = distance.assign_plain(X, C, "bf16")
    ties16 = near_ties_16(X, C, "bf16").numpy()
    if data == "blobs":
        assert ties16.sum() <= 2 and ties8.sum() <= 2
    np.testing.assert_array_equal(ids16[~ties16], pids16.numpy()[~ties16])
    xs = X.bfloat16().float().numpy()
    assert np.all(np.abs(d16 - pd16.numpy())
                  <= d_bound(xs, c, pids16.numpy()) + 1e-6)

    for ids in (ids8, ids16):
        assert np.all((ids >= 0) & (ids < k))
        if data == "ties":
            assert not np.isin(ids, [1, 8, bn, bn + 3, k - 1]).any()
            np.testing.assert_array_equal(
                ids[:8], [0, 0, 3, 3, k - bn - 1, k - bn - 1, 0, 2])


# --------------------------------------------------------------------------
# kernel B (a register-tiled CUDA-core product) against the body it
# replaced, and B3 (a wgmma product on the bf16 hi and lo parts)
# --------------------------------------------------------------------------

B_CASES = [  # (m, k, n, grid, shift, data)
    (300, 25, 28, 2, 0, "ties"),       # the main path's k and n: one tile
    (300, 25, 28, 1, 1, "far"),        # of 32 centroids, 7 padded columns;
    (257, 32, 3, 3, 0, "blobs"),       # rows off 16 bytes; k = 32 (a full
    (200, 33, 37, 2, 1, "ties"),       # tile), 33 (a tile of 128, 95
    (200, 130, 68, 2, 0, "ties"),      # padded); k = 130, 300: two and
    (130, 300, 1024, 2, 0, "ties"),    # three tiles, the last ragged;
    (70, 300, 1100, 1, 3, "far"),      # n = 3, 37, 68, 1,024, 1,100;
    (129, 130, 1100, 3, 1, "extremes"),  # -0.0, rows whose every score
]                                      # is >= 1e30 or NaN


def b_inputs(m, k, n, data, seed):
    """(x, c): blobs; 'ties': twin centroids within a thread's columns (0
    and 1; 4 and 64, the lower in the higher lane), across lanes (2 and 8)
    and across centroid tiles (j and j + 128), the first rows at each twin;
    'far': every real score above 0, where a padded column would score 0;
    'extremes': -0.0 in x and c, a row whose scores are all above 1e30 and
    a row of NaN scores."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(k, n)) * 5).astype(np.float32)
    twins = [(0, 1), (2, 8)] + ([(4, 64)] if k > 64 else []) + [
        (j, j + 128) for j in (3, k - 129) if 0 <= j and j + 128 < k]
    if data == "ties":
        for lo, hi in twins:
            c[hi] = c[lo]
    comp = rng.integers(0, k, m)
    if data == "ties":                   # the first rows at each twin
        firsts = [j for pair in twins for j in pair]
        comp[:len(firsts)] = firsts
    x = c[comp] + rng.normal(size=(m, n))
    if data == "far":
        c += 40.0
        x = rng.normal(size=(m, n))
    if data == "extremes":
        c = np.abs(c) + 1.0
        x[::5, ::3] = -0.0
        c[::4, ::2] = -0.0
        x[7] = -3e28                     # x.c far below 0: every score
        x[11, 5] = np.nan                # above 1e30; NaN scores
    return x.astype(np.float32), c, twins


@pytest.mark.parametrize("case", B_CASES, ids=[
    f"m{m}-k{k}-n{n}-g{g}-s{sh}-{data}" for m, k, n, g, sh, data in B_CASES])
def test_f32_assign_source_bitwise_parent_body(harness, tmp_path, case):
    """Kernel B (tiles of 32 or 128 centroids, 8-row microtiles, slabs
    staged by cp.async held to their waits) bitwise the CUDA-core body it
    replaced (``common.cuh:assign_cta`` under F32Ops): ids and d, on
    ragged m, rows off 16 bytes, exact ties within a thread's columns,
    across lanes and across centroid tiles, padded columns that would win
    if masked by value, -0.0, and rows whose every score is >= 1e30 or NaN
    (id 0).  B3 (three bf16 products a slab on the wgmma emulation)
    against its plain version: ids off near ties, d within the f32 norm
    bound, twins resolved to the lower index."""
    m, k, n, grid, shift, data = case
    x, c, twins = b_inputs(m, k, n, data, seed=m + k + n)
    (tmp_path / "in.bin").write_bytes(x.tobytes() + c.tobytes())
    subprocess.run([str(harness.parent / "harness_b"), str(m), str(k),
                    str(n), str(grid), str(shift), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=300)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.int32)
    assert raw.size == 6 * m
    ids, d, pids, pd, ids3, d3 = (raw[i * m:(i + 1) * m] for i in range(6))
    np.testing.assert_array_equal(ids, pids)
    np.testing.assert_array_equal(d, pd)          # bitwise, as int32 words
    assert np.all((ids >= 0) & (ids < k))
    if data == "ties":
        losers = [hi for _, hi in twins]
        assert not np.isin(ids, losers).any()
        assert not np.isin(ids3, losers).any()
    if data == "extremes":
        assert ids[7] == 0 and ids[11] == 0
        return
    X, C = torch.from_numpy(x), torch.from_numpy(c)
    want, want_d = distance.assign_plain(X, C)
    ties = near_ties_16(X, C, "f32").numpy()
    np.testing.assert_array_equal(ids[~ties], want.numpy()[~ties])
    pids3, pd3 = distance.assign_plain(X, C, "bf16x3")
    ties3 = near_ties_16(X, C, "bf16x3").numpy()
    if data == "blobs":
        assert ties3.sum() <= 2
    np.testing.assert_array_equal(ids3[~ties3], pids3.numpy()[~ties3])
    assert np.all(np.abs(d3.view(np.float32) - pd3.numpy())
                  <= d_bound(x, c, pids3.numpy()) + 1e-6)


# --------------------------------------------------------------------------
# the fused bodies' sorted scatter against the one-hot body it replaced
# --------------------------------------------------------------------------

ONEHOT_CASES = [  # (m, k, n, grid, shift, data), B = 3 streams
    (600, 25, 28, 2, 1, "blobs"),     # the main path's k and n: a ragged
    (100, 25, 28, 1, 0, "blobs"),     # last tile, a CTA with two tiles; m
    (513, 33, 37, 2, 1, "blobs"),     # below one tile; n = 37 and 68
    (300, 70, 68, 2, 3, "blobs"),     # (feature slabs, the last ragged);
    (600, 300, 7, 2, 1, "blobs"),     # k = 300 > 256 rows a tile; cluster
    (1000, 25, 28, 2, 0, "layout"),   # 5 absent from CTA 0's first tile,
    (600, 25, 37, 2, 1, "extremes"),  # present in its second, a tile of
    (257, 1, 5, 3, 2, "blobs"),       # one cluster; -0.0, +-inf, huge
]                                     # values; k = 1, a CTA with no tile
B_ONEHOT = 3


def onehot_inputs(m, k, n, data, seed):
    """(x [B,m,n], c [B,k,n]) f32 around well-separated centres.  'layout':
    tile 0 (CTA 0's first) holds no row of cluster 5, tile 2 (its second)
    does, tile 1 is all cluster 3.  'extremes': rows and entries of -0.0,
    +inf and -inf entries, and rows of +-3e38 whose sums overflow."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(B_ONEHOT, k, n)) * 10).astype(np.float32)
    comp = rng.integers(0, k, (B_ONEHOT, m))
    if data == "layout":
        comp[:, :256] = rng.choice([j for j in range(k) if j != 5],
                                   (B_ONEHOT, 256))
        comp[:, 256:512] = 3
        comp[:, 512:520] = 5
    x = np.stack([c[b][comp[b]] for b in range(B_ONEHOT)])
    x = x + rng.normal(size=x.shape)
    if data == "extremes":
        x[:, 10:20] = -0.0
        x[:, ::5, ::3] = -0.0
        x[:, 3, 2] = np.inf
        x[:, 7, 4] = -np.inf
        x[:, 40:44] = 3e38
        x[:, 44:46, ::2] = -3e38
    return x.astype(np.float32), c


@pytest.mark.parametrize("case", ONEHOT_CASES, ids=[
    f"m{m}-k{k}-n{n}-g{g}-s{sh}-{data}"
    for m, k, n, g, sh, data in ONEHOT_CASES])
def test_fused_sources_bitwise_onehot_body(harness, tmp_path, case):
    """Kernels A, A16, A3, A8, each stream of D, D16, D3, D8 (B = 3) and the
    four dma twins (base `shift` elements off) — whose CTA bodies sort each
    tile into runs of one cluster and sum each run in row order — bitwise
    the one-hot body they replaced (``onehot.cuh``, on A's grid): sums (int8:
    the int32 sums), counts and objective.  Every partial buffer starts as
    garbage, so a cluster absent from a CTA's first tile must still get its
    +0."""
    m, k, n, grid, shift, data = case
    x, c = onehot_inputs(m, k, n, data, seed=m + k + n)
    X, C = torch.from_numpy(x), torch.from_numpy(c)
    xb = X.bfloat16().view(torch.int16).numpy()
    qx = px.quantize_chunk(torch.from_numpy(np.nan_to_num(
        x, posinf=0.0, neginf=0.0)))
    cq, t = px.quantize_centroids(C, qx.scale)
    (tmp_path / "in.bin").write_bytes(b"".join(
        a.tobytes() for a in (x, xb, qx.q.numpy(), c, cq.numpy(),
                              qx.scale.numpy(), t.numpy())))
    subprocess.run([str(harness.parent / "harness_onehot"), str(B_ONEHOT),
                    str(m), str(k), str(n), str(grid), str(shift),
                    str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=300)
    raw = np.fromfile(tmp_path / "out.bin", dtype=np.uint32)
    kn, sf, runs = k * n, k * n + k + 1, 3 * B_ONEHOT + 1
    assert raw.size == 4 * runs * sf
    for i, prec in enumerate(("f32", "bf16", "bf16x3", "int8")):
        got = raw[i * runs * sf:(i + 1) * runs * sf].reshape(runs, sf)
        for b in range(B_ONEHOT):
            parent = got[3 * b]
            np.testing.assert_array_equal(got[3 * b + 1], parent,
                                          err_msg=f"{prec} A, stream {b}")
            np.testing.assert_array_equal(got[3 * b + 2], parent,
                                          err_msg=f"{prec} D, stream {b}")
            assert got[3 * b, kn:kn + k].view(np.float32).sum() == m, prec
        np.testing.assert_array_equal(got[-1], got[0], err_msg=f"{prec} dma")
    if data == "layout":                 # cluster 5 only from tile 2 on
        ids, _ = ref.assign_ref(X[0], C[0])
        ids = ids.numpy()
        assert 5 not in ids[:256] and 5 in ids[512:768]
        assert np.all(ids[256:512] == 3)
        np.testing.assert_array_equal(raw[kn:kn + k].view(np.float32),
                                      np.bincount(ids, minlength=k))
