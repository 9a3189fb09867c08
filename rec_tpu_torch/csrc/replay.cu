// The beam-search coder's decode replay for Hopper (sm_90a): one launch
// per call in place of the eager chain of ops/replay.py::replay_blocks_ref
// (about 1,240 tiny int64 and float64 kernels a call at N=9, P=24).
//
// It replaces no TPU kernel: in rec_tpu the replay is plain jnp inside the
// jitted coder, fused by XLA.  It was added because the eager chain's host
// dispatch, not its arithmetic, set the pace of serving on this card.
//
// For each block n and each live step t < min(count[n], P):
//   1. step key  = fold_in(block_key[n], t)
//   2. h_t       = FNV-1a hash of idx[n, 0..t-1] (the winning history)
//   3. stream key = fold_in(step key, h_t), or fold_in(step key, POOL_TAG)
//      for the shared-pool contract
//   4. bits of counter idx[n, t] * D + d, by the fmix or threefry stream
//   5. eps = normal_table[(bits >> 9) & (2^23 - 1)], the same 32 MiB table
//      (rng.normal_table) that the eager path reads
//   6. acc = fma(sqrt(w[n, t]), eps, acc), t = 0, 1, ... from acc = +0
// and then out[n, d] = fma(scale[n, d], acc, loc[n, d]).  __fmaf_rn and
// __fsqrt_rn are correctly rounded, as the eager chain's fma_f32_exact and
// sqrt_f32 are, so the bits are the eager path's (and rec_tpu's).  A dead
// step (t >= count, w = 0) would add fma(0, eps, acc) = acc, since acc is
// never -0 and eps is finite, so only the live steps are walked.
//
// What bounds it.  The table gathers: N * L * D random 4-byte reads into a
// table that stays in the 50 MB L2, plus 3 * N * D floats streamed, and the
// bits' integer work (18 lane instructions an element for fmix, 69 for
// threefry).  At the serving shapes (N = 9 or 72, D = 1000, P = 24) that is
// under a microsecond of either, so one call takes about a launch and the
// latency of a block's L sequential steps.
//
// The design.  One CTA holds one block's dims d0 .. d0 + blockDim.x (a
// whole warp count, at most kThreads, fewer for a small D), so the grid is
// N * ceil(D / blockDim.x) CTAs and N = 9 already spreads over most SMs.
// Each CTA first derives its block's stream keys, square-rooted weights
// and counter bases for a tile of kTile steps into shared memory: the
// threads load the tile's indices and weights in parallel, one thread
// walks the FNV chain (a serial xor-multiply, a few hundred cycles), then
// the threads take one step each for the two threefry evaluations.  Every
// thread then walks the tile's steps for its dim, kUnroll table gathers in
// flight before their fmas, which keep the fixed order t = 0, 1, ...  The
// keys are recomputed by each CTA of a block (2 threefry a step), which is
// cheaper than a second launch or a grid barrier.  The kernel allocates
// nothing, launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "streams.cuh"

namespace {

constexpr int kThreads = 128;       // most dims of one CTA
constexpr int kTile = 128;          // steps whose keys sit in shared memory
constexpr int kUnroll = 8;          // table gathers in flight per thread
constexpr uint32_t kPoolTag = 0x900Du;
constexpr uint32_t kTableMask = (1u << 23) - 1u;

struct Args {
  const float* loc;         // (N, D)
  const float* scale;       // (N, D)
  const float* w;           // (N, P) schedule weights
  const int* idx;           // (N, P) chosen candidates
  const int64_t* counts;    // (N,) partition counts
  const int64_t* bkeys;     // (N, 2) block keys, uint32 words
  const float* table;       // (2^23,) the normal map by bits >> 9
  float* out;               // (N, D)
  int N, D, P, chunks;
};

template <int STREAM>
__device__ __forceinline__ float normal(const float* table, uint32_t k1,
                                        uint32_t k2, uint32_t ctr) {
  const uint32_t bits =
      STREAM == 0 ? fmix_bits(k1, k2, ctr) : threefry_bits(k1, k2, ctr);
  return __ldg(table + ((bits >> 9) & kTableMask));
}

template <int STREAM, bool POOL>
__global__ void __launch_bounds__(kThreads) replay_kernel(Args a) {
  __shared__ uint32_t s_idx[kTile];
  __shared__ uint32_t s_k1[kTile];
  __shared__ uint32_t s_k2[kTile];
  __shared__ float s_sw[kTile];
  __shared__ uint32_t s_h[kTile];

  const int n = blockIdx.x / a.chunks;
  const int d = (blockIdx.x - n * a.chunks) * blockDim.x + threadIdx.x;
  const int P = a.P, D = a.D;
  const int64_t cnt = a.counts[n];
  const int L = cnt < 0 ? 0 : (cnt > P ? P : (int)cnt);
  const uint32_t bk1 = (uint32_t)a.bkeys[2 * n];
  const uint32_t bk2 = (uint32_t)a.bkeys[2 * n + 1];
  const int* idx = a.idx + (size_t)n * P;
  const float* w = a.w + (size_t)n * P;

  float acc = 0.0f;
  uint32_t h = kFnvOffset;   // carried by thread 0 across tiles
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int m = min(kTile, L - t0);
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      s_idx[j] = (uint32_t)idx[t0 + j];
      s_sw[j] = __fsqrt_rn(w[t0 + j]);
    }
    __syncthreads();
    if (!POOL && threadIdx.x == 0) {
      for (int j = 0; j < m; ++j) {
        s_h[j] = h;
        h = (h ^ s_idx[j]) * kFnvPrime;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      uint32_t s1, s2;
      fold_in(bk1, bk2, (uint32_t)(t0 + j), s1, s2);
      fold_in(s1, s2, POOL ? kPoolTag : s_h[j], s_k1[j], s_k2[j]);
      s_idx[j] *= (uint32_t)D;    // the step's counter base
    }
    __syncthreads();
    if (d < D) {
      const uint32_t ud = (uint32_t)d;
      int j = 0;
      for (; j + kUnroll <= m; j += kUnroll) {
        float eps[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          eps[u] = normal<STREAM>(a.table, s_k1[j + u], s_k2[j + u],
                                  s_idx[j + u] + ud);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          acc = __fmaf_rn(s_sw[j + u], eps[u], acc);
      }
      for (; j < m; ++j)
        acc = __fmaf_rn(s_sw[j],
                        normal<STREAM>(a.table, s_k1[j], s_k2[j],
                                       s_idx[j] + ud),
                        acc);
    }
    __syncthreads();   // the next tile overwrites shared memory
  }
  if (d < D) {
    const size_t o = (size_t)n * D + d;
    a.out[o] = __fmaf_rn(a.scale[o], acc, a.loc[o]);
  }
}

}  // namespace

// C entry point (bound with ctypes).  stream_kind: 0 = fmix, 1 = threefry;
// shared_pool: 0 = per-beam history streams, 1 = the shared pool's.
// Returns the CUDA error code of the launch (0 with nothing to do).
extern "C" int replay_launch(const void* loc, const void* scale,
                             const void* w, const void* idx,
                             const void* counts, const void* bkeys,
                             const void* table, void* out, int N, int D,
                             int P, int stream_kind, int shared_pool,
                             void* stream) {
  if (N < 0 || D < 0 || P < 0 || stream_kind < 0 || stream_kind > 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || D == 0) return 0;
  const int warps = (D + 31) / 32;
  const int threads = warps < kThreads / 32 ? 32 * warps : kThreads;
  const int chunks = (D + threads - 1) / threads;
  if ((long long)N * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(loc), static_cast<const float*>(scale),
         static_cast<const float*>(w), static_cast<const int*>(idx),
         static_cast<const int64_t*>(counts),
         static_cast<const int64_t*>(bkeys),
         static_cast<const float*>(table), static_cast<float*>(out),
         N, D, P, chunks};
  const dim3 grid(N * chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stream_kind == 0 && !shared_pool)
    replay_kernel<0, false><<<grid, threads, 0, s>>>(a);
  else if (stream_kind == 0)
    replay_kernel<0, true><<<grid, threads, 0, s>>>(a);
  else if (!shared_pool)
    replay_kernel<1, false><<<grid, threads, 0, s>>>(a);
  else
    replay_kernel<1, true><<<grid, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
