// Phases of the fused CTA bodies (kernels A, A8, A16, A3), timed apart by
// tools/profile_fused.py.  Compiled against a tree's kernels/csrc, so that
// the phases are that tree's code:
//   probe_argmin_*  the body up to its accumulate phase: per point tile,
//                   common.cuh:tile_argmin (tile_argmin_q) and the
//                   objective's block_sum, on the fused kernel's grid;
//   probe_runs_*    the same, then the tile's sort into runs
//                   (common.cuh:find_runs); built with -DPROBE_RUNS, for a
//                   tree whose fused bodies scatter sorted runs.
// A fused kernel's time less probe_argmin's is its accumulate phase.
#include "common.cuh"

using namespace repro;

template <class Ops, bool Runs>
__device__ __forceinline__ void argmin_phase(
    const typename Ops::X* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ csq, float* __restrict__ out, int64_t m, int k,
    int n, int64_t num_tiles) {
  __shared__ TileSmemT<Ops> s;
  SyncLoad xin;
  float obj = 0.f;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin(s, x, c, m, k, n, r0, bidx, best, xsq, xin, csq);
    const bool valid = r0 + threadIdx.x < m;
    s.ids[threadIdx.x] = valid ? bidx : -1;
#ifdef PROBE_RUNS
    s.runs.key[threadIdx.x] = run_key(valid ? (unsigned)bidx : ABSENT);
#endif
    obj += block_sum(s, valid ? fmaxf(best + xsq, 0.f) : 0.f);
#ifdef PROBE_RUNS
    if (Runs) {
      find_runs(s.runs, k);
      obj += (float)s.runs.runs;
    }
#endif
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = obj;
}

template <bool Runs>
__device__ __forceinline__ void argmin_phase_q(
    const int8_t* __restrict__ x, const int8_t* __restrict__ c,
    const float* __restrict__ csq, const float* __restrict__ tq,
    const float* __restrict__ scale, float* __restrict__ out, int64_t m,
    int k, int n, int64_t num_tiles) {
  __shared__ TileSmemQ s;
  SyncLoad xin;
  float obj = 0.f;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TM;
    int bidx;
    float best, xsq;
    tile_argmin_q(s, x, c, csq, tq, scale, m, k, n, r0, bidx, best, xsq,
                  xin);
    const bool valid = r0 + threadIdx.x < m;
    s.ids[threadIdx.x] = valid ? bidx : -1;
#ifdef PROBE_RUNS
    s.runs.key[threadIdx.x] = run_key(valid ? (unsigned)bidx : ABSENT);
#endif
    obj += block_sum(s, valid ? fmaxf(best + xsq, 0.f) : 0.f);
#ifdef PROBE_RUNS
    if (Runs) {
      find_runs(s.runs, k);
      obj += (float)s.runs.runs;
    }
#endif
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = obj;
}

#define FLOAT_PROBE(name, Ops, Runs)                                        \
  extern "C" __global__ void __launch_bounds__(TM)                         \
      name(const Ops::X* __restrict__ x, const float* __restrict__ c,      \
           const float* __restrict__ csq, float* __restrict__ out,         \
           int64_t m, int k, int n, int64_t num_tiles) {                   \
    argmin_phase<Ops, Runs>(x, c, csq, out, m, k, n, num_tiles);           \
  }
FLOAT_PROBE(probe_argmin_f32, F32Ops, false)
FLOAT_PROBE(probe_argmin_bf16, Bf16Ops, false)
FLOAT_PROBE(probe_argmin_bf16x3, Bf16x3Ops, false)
FLOAT_PROBE(probe_runs_f32, F32Ops, true)

extern "C" __global__ void __launch_bounds__(TM)
probe_argmin_int8(const int8_t* __restrict__ x, const int8_t* __restrict__ c,
                  const float* __restrict__ csq, const float* __restrict__ tq,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int64_t m, int k, int n, int64_t num_tiles) {
  argmin_phase_q<false>(x, c, csq, tq, scale, out, m, k, n, num_tiles);
}

extern "C" __global__ void __launch_bounds__(TM)
probe_runs_int8(const int8_t* __restrict__ x, const int8_t* __restrict__ c,
                const float* __restrict__ csq, const float* __restrict__ tq,
                const float* __restrict__ scale, float* __restrict__ out,
                int64_t m, int k, int n, int64_t num_tiles) {
  argmin_phase_q<true>(x, c, csq, tq, scale, out, m, k, n, num_tiles);
}

// policy: 0 f32, 1 bf16, 2 bf16x3, 3 int8; runs: the sort too.  c is the
// f32 centroids (int8: their codes, with tq and scale), csq their norms;
// out [grid].  Returns a cudaError_t.
extern "C" int probe_launch(int policy, int runs, const void* x,
                            const void* c, const float* csq, const float* tq,
                            const float* scale, float* out, int64_t m, int k,
                            int n, int grid, void* stream) {
  const int64_t num_tiles = (m + TM - 1) / TM;
  cudaStream_t st = (cudaStream_t)stream;
  const float* cf = static_cast<const float*>(c);
  switch (policy * 2 + (runs ? 1 : 0)) {
    case 0:
      probe_argmin_f32<<<grid, TM, 0, st>>>(static_cast<const float*>(x), cf,
                                           csq, out, m, k, n, num_tiles);
      break;
    case 1:
      probe_runs_f32<<<grid, TM, 0, st>>>(static_cast<const float*>(x), cf,
                                         csq, out, m, k, n, num_tiles);
      break;
    case 2:
      probe_argmin_bf16<<<grid, TM, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), cf, csq, out, m, k, n,
          num_tiles);
      break;
    case 4:
      probe_argmin_bf16x3<<<grid, TM, 0, st>>>(static_cast<const float*>(x),
                                              cf, csq, out, m, k, n,
                                              num_tiles);
      break;
    case 6:
    case 7: {
      const int8_t* xq = static_cast<const int8_t*>(x);
      const int8_t* cq = static_cast<const int8_t*>(c);
      if (runs)
        probe_runs_int8<<<grid, TM, 0, st>>>(xq, cq, csq, tq, scale, out, m,
                                            k, n, num_tiles);
      else
        probe_argmin_int8<<<grid, TM, 0, st>>>(xq, cq, csq, tq, scale, out,
                                              m, k, n, num_tiles);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
