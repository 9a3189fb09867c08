// Whole-partition beam-search encode for Hopper (sm_90a).
//
// Replaces the TPU kernel rec_tpu/ops/mega_beam.py::_kernel (Pallas, built
// by _mega_call).  For each of N latent blocks it runs the whole beam-search
// partition chain: per live step t < count[nb],
//   1. step key = fold_in(block_key, t)                    (threefry2x32)
//   2. beam key = fold_in(step_key, FNV history hash)      per beam
//   3. candidate s = counter rows [s*D, (s+1)*D) of the beam key's fmix or
//      threefry bit stream, mapped through XLA's erfinv-normal polynomial
//   4. score = sum_d (qa*x + qb)*x with x = beam + ascale*eps
//   5. iterative top-B over the (S_pad, 128) selection tile of the Pallas
//      kernel: max wins, ties to the lowest s*128 + b, a NaN score picks
//      (0, 0), and once every remaining score is -inf the lowest -inf slot
//      of the tile (padding included) is picked
//   6. regenerate the B winning rows and parent-gather beams, history and
//      hashes.
// It returns the winning beam's (N, P) indices.
//
// Design for the GPU.  The TPU grid's sequential partition axis becomes a
// loop inside one thread block per latent block (blocks carry nothing
// between them on Hopper).  Candidate rows are scored one warp per row, the
// sum over D reduced with shuffles; selection is a block-wide argmax per
// pick.  Beams (B x D f32, double-buffered) and the index history (B x P
// i32, double-buffered) live in global scratch allocated by the caller, so
// budgets of thousands of partitions need no shared memory; beams and the
// schedule rows stay hot in L1/L2.  The kernel allocates nothing, launches
// on the caller's stream, and is selection-only: its floats are faithful,
// not exact (the sample reported to the user is the decode replay).
//
// What bounds it.  Operations, not bytes: at the main-path shape (N=9 latent
// blocks, D=1000, B=20, S=36, P=24) one call scores about
// 9 * (36*1000 + 23*20*36*1000) = 1.5e8 candidate elements at ~53 integer
// and f32 operations each (fmix bits, erfinv polynomial, score), ~8e9
// operations, against ~2.6 MB of qa/qb/ascale.  With one image only 9 of
// the H100's 132 SMs have work.  Batched serving flattens (image, block)
// into this kernel's block axis (rec_tpu's custom-vmap rule), so at the
// serving batch of 8 one launch per res block carries N = 72 blocks on 72
// SMs; filling the rest (splitting beams across a cluster) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;          // selection tile columns (beams)
constexpr int kBig = 1 << 30;       // "no slot" sentinel, as in the Pallas kernel
constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421356f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x0 += k1;
  x1 += k2;
#define TF_ROUND(r) { x0 += x1; x1 = rotl(x1, r); x1 ^= x0; }
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k3 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k3; x1 += k1 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k3 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#undef TF_ROUND
  o0 = x0 + k3;
  o1 = x1 + k1 + 5u;
}

__device__ __forceinline__ void fold_in(uint32_t k1, uint32_t k2,
                                        uint32_t data, uint32_t& o0,
                                        uint32_t& o1) {
  threefry2x32(k1, k2, 0u, data, o0, o1);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <int STREAM>
__device__ __forceinline__ uint32_t stream_bits(uint32_t k1, uint32_t k2,
                                                uint32_t ctr) {
  if (STREAM == 0) {
    return fmix32(fmix32(ctr * kGolden + k1) ^ k2);
  } else {
    uint32_t o0, o1;
    threefry2x32(k1, k2, 0u, ctr, o0, o1);
    return o0 ^ o1;
  }
}

// jax.random.normal's bits -> normal map with XLA's single-precision
// erf_inv polynomial (faithful to ~1 ulp; selection only).
__device__ __forceinline__ float bits_to_normal(uint32_t bits) {
  const float x01 = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(x01 * 2.0f + kLo, kLo);
  float w = -log1pf(-u * u);
  float p;
  if (w < 5.0f) {
    w = w - 2.5f;
    p = 2.81022636e-08f;
    p = fmaf(p, w, 3.43273939e-07f);
    p = fmaf(p, w, -3.5233877e-06f);
    p = fmaf(p, w, -4.39150654e-06f);
    p = fmaf(p, w, 0.00021858087f);
    p = fmaf(p, w, -0.00125372503f);
    p = fmaf(p, w, -0.00417768164f);
    p = fmaf(p, w, 0.246640727f);
    p = fmaf(p, w, 1.50140941f);
  } else {
    w = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = fmaf(p, w, 0.000100950558f);
    p = fmaf(p, w, 0.00134934322f);
    p = fmaf(p, w, -0.00367342844f);
    p = fmaf(p, w, 0.00573950773f);
    p = fmaf(p, w, -0.0076224613f);
    p = fmaf(p, w, 0.00943887047f);
    p = fmaf(p, w, 1.00167406f);
    p = fmaf(p, w, 2.83297682f);
  }
  return (p * u) * kSqrt2;
}

// Selection order: larger value first, then lower tile slot.  -0 and +0
// compare equal, as the Pallas kernel's `sc_all == m` does.
__device__ __forceinline__ bool better(float v, int f, float bv, int bf) {
  return v > bv || (v == bv && f < bf);
}

template <int STREAM>
__global__ void __launch_bounds__(kThreads, 1)
mega_beam_kernel(const int* __restrict__ counts,
                 const uint32_t* __restrict__ bkeys,
                 const float* __restrict__ qa,
                 const float* __restrict__ qb,
                 const float* __restrict__ ascale,
                 int* __restrict__ out,
                 float* __restrict__ beams_g,   // (N, 2, B, D)
                 int* __restrict__ hist_g,      // (N, 2, B, P)
                 int D, int B, int S, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* scores = reinterpret_cast<float*>(smem_raw);            // B*S
  uint32_t* bk1 = reinterpret_cast<uint32_t*>(scores + B * S);   // B
  uint32_t* bk2 = bk1 + B;                                       // B
  uint32_t* hashes = bk2 + B;                                    // B
  uint32_t* hashes_tmp = hashes + B;                             // B
  int* parents = reinterpret_cast<int*>(hashes_tmp + B);         // B
  int* cands = parents + B;                                      // B
  float* red_v = reinterpret_cast<float*>(cands + B);            // kWarps
  int* red_f = reinterpret_cast<int*>(red_v + kWarps);           // kWarps
  int* red_nan = red_f + kWarps;                                 // kWarps

  const int nb = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_b = min(counts[nb], P);
  const int S_pad = (S + 7) / 8 * 8;
  const uint32_t key1 = bkeys[2 * nb], key2 = bkeys[2 * nb + 1];
  float* beams[2] = {beams_g + (size_t)nb * 2 * B * D,
                     beams_g + (size_t)nb * 2 * B * D + (size_t)B * D};
  int* hist[2] = {hist_g + (size_t)nb * 2 * B * P,
                  hist_g + (size_t)nb * 2 * B * P + (size_t)B * P};

  for (int i = tid; i < B * D; i += kThreads) beams[0][i] = 0.0f;
  for (int i = tid; i < B * P; i += kThreads) hist[0][i] = 0;
  for (int b = tid; b < B; b += kThreads) hashes[b] = kFnvOffset;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < n_b; ++t) {
    const size_t row = ((size_t)nb * P + t) * D;
    const float* qa_t = qa + row;
    const float* qb_t = qb + row;
    const float* as_t = ascale + row;

    // --- per-beam stream keys: fold_in(fold_in(block_key, t), hash) -----
    for (int b = tid; b < B; b += kThreads) {
      uint32_t s1, s2, o1, o2;
      fold_in(key1, key2, (uint32_t)t, s1, s2);
      fold_in(s1, s2, hashes[b], o1, o2);
      bk1[b] = o1;
      bk2[b] = o2;
    }
    __syncthreads();

    // --- candidate generation + scoring: one warp per (beam, candidate) -
    // At t == 0 every beam shares the empty history: only beam 0 scores.
    const int n_rows = (t == 0) ? S : B * S;
    const float* beam_cur = beams[cur];
    for (int r = warp; r < n_rows; r += kWarps) {
      const int b = r / S, s = r % S;
      const uint32_t k1 = bk1[b], k2 = bk2[b];
      const float* beam = beam_cur + (size_t)b * D;
      const uint32_t base = (uint32_t)s * (uint32_t)D;
      float acc = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float eps = bits_to_normal(stream_bits<STREAM>(k1, k2,
                                                             base + d));
        const float x = beam[d] + __ldg(as_t + d) * eps;
        acc += (__ldg(qa_t + d) * x + __ldg(qb_t + d)) * x;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) scores[b * S + s] = acc;
    }
    __syncthreads();

    // --- iterative top-B over the selection tile ------------------------
    // Valid slots: s < S, b < B, and b == 0 at t == 0.  Every other slot of
    // the (S_pad, 128) tile holds -inf, and a picked slot becomes -inf.
    int min_invalid = kBig;  // lowest invalid slot s*128 + b
    if (t == 0) min_invalid = 1;
    else if (B < kCols) min_invalid = B;
    else if (S < S_pad) min_invalid = S * kCols;
    for (int k = 0; k < B; ++k) {
      float bv = -INFINITY;
      int bf = kBig;
      int nan = 0;
      for (int e = tid; e < n_rows; e += kThreads) {
        const int b = e / S, s = e % S;
        const float v = scores[e];
        const int f = s * kCols + b;
        if (isnan(v)) nan = 1;
        else if (better(v, f, bv, bf)) { bv = v; bf = f; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int of = __shfl_xor_sync(0xffffffffu, bf, off);
        nan |= __shfl_xor_sync(0xffffffffu, nan, off);
        if (better(ov, of, bv, bf)) { bv = ov; bf = of; }
      }
      if (lane == 0) { red_v[warp] = bv; red_f[warp] = bf; red_nan[warp] = nan; }
      __syncthreads();
      if (tid == 0) {
        bv = red_v[0]; bf = red_f[0]; nan = red_nan[0];
        for (int w = 1; w < kWarps; ++w) {
          nan |= red_nan[w];
          if (better(red_v[w], red_f[w], bv, bf)) { bv = red_v[w]; bf = red_f[w]; }
        }
        int f;
        if (nan) f = 0;                               // NaN max: sentinel -> 0
        else if (bv == -INFINITY) f = min(bf, min_invalid);
        else f = bf;
        if (f >= kBig) f = 0;
        const int pb = f % kCols, ps = f / kCols;
        parents[k] = pb;
        cands[k] = ps;
        if (ps < S && pb < B && (t > 0 || pb == 0))
          scores[pb * S + ps] = -INFINITY;
      }
      __syncthreads();
    }

    // --- carry update: regenerate the B winning rows --------------------
    const int nxt = cur ^ 1;
    for (int k = warp; k < B; k += kWarps) {
      const int p = min(parents[k], B - 1);   // padding columns clamp
      const uint32_t c = (uint32_t)cands[k];
      const uint32_t k1 = bk1[p], k2 = bk2[p];
      const float* src = beams[cur] + (size_t)p * D;
      float* dst = beams[nxt] + (size_t)k * D;
      for (int d = lane; d < D; d += 32) {
        const float eps = bits_to_normal(stream_bits<STREAM>(
            k1, k2, c * (uint32_t)D + (uint32_t)d));
        dst[d] = src[d] + __ldg(as_t + d) * eps;
      }
    }
    for (int i = tid; i < B * P; i += kThreads) {
      const int k = i / P, j = i % P;
      const int p = min(parents[k], B - 1);
      hist[nxt][i] = (j == t) ? cands[k] : hist[cur][p * P + j];
    }
    for (int k = tid; k < B; k += kThreads) {
      const int p = min(parents[k], B - 1);
      hashes_tmp[k] = (hashes[p] ^ (uint32_t)cands[k]) * kFnvPrime;
    }
    __syncthreads();
    for (int k = tid; k < B; k += kThreads) hashes[k] = hashes_tmp[k];
    cur = nxt;
    __syncthreads();
  }

  for (int j = tid; j < P; j += kThreads)
    out[(size_t)nb * P + j] = hist[cur][j];
}

template <int STREAM>
cudaError_t launch(const int* counts, const uint32_t* bkeys, const float* qa,
                   const float* qb, const float* ascale, int* out,
                   float* beams, int* hist, int N, int D, int B, int S,
                   int P, cudaStream_t stream) {
  const size_t smem = (size_t)B * S * sizeof(float)
                      + 6 * (size_t)B * sizeof(uint32_t)
                      + 3 * (size_t)kWarps * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mega_beam_kernel<STREAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  mega_beam_kernel<STREAM><<<N, kThreads, smem, stream>>>(
      counts, bkeys, qa, qb, ascale, out, beams, hist, D, B, S, P);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  stream_kind: 0 = fmix, 1 = threefry.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mega_beam_launch(const void* counts, const void* bkeys,
                                const void* qa, const void* qb,
                                const void* ascale, void* out, void* beams,
                                void* hist, int N, int D, int B, int S,
                                int P, int stream_kind, void* stream) {
  if (N <= 0) return 0;
  if (B < 1 || B > kCols || S < 1 || S > kCols || D < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  auto c = static_cast<const int*>(counts);
  auto k = static_cast<const uint32_t*>(bkeys);
  auto a = static_cast<const float*>(qa);
  auto b = static_cast<const float*>(qb);
  auto s = static_cast<const float*>(ascale);
  auto o = static_cast<int*>(out);
  auto bm = static_cast<float*>(beams);
  auto h = static_cast<int*>(hist);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = stream_kind == 0
      ? launch<0>(c, k, a, b, s, o, bm, h, N, D, B, S, P, st)
      : launch<1>(c, k, a, b, s, o, bm, h, N, D, B, S, P, st);
  return (int)e;
}
