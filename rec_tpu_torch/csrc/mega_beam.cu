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
// What bounds it.  Instructions, not bytes.  At the serving shape (N=72
// latent blocks, D=1000, B=20, S=36, P=24) one call scores and regenerates
// ~1.1e9 candidate elements against ~21 MB of qa/qb/ascale.  An fmix
// element needs 36 lane instructions: 18 integer ones for the bits (13 of
// them shifts and logic on the INT32 pipe, 5 multiplies on the FMA pipe),
// 15 float ones for the normal map with the hardware lg2 and 3 FMAs for the
// score; a threefry element needs 87, 70 of them on the INT32 pipe.  The
// H100 issues 128 lane instructions per clock per SM (132 SMs, ~33.5e12/s
// at 1.98 GHz) and its INT32 pipe takes 64 (~16.7e12/s), so an fmix call
// at N=72 needs ~1.2 ms of issue, a threefry call is bound by the INT32
// pipe, and HBM needs 6 us (chip_smoke.py's mega_beam_bound counts this).
// A kernel with one thread block per latent block keeps 9 or 72 of the 132
// SMs busy, each SM walking its block's 24 steps alone, and takes the same
// time at both N.
//
// The design.  A block's partition steps are sequential, but the rows of
// one step are independent, so the chain is spread over the whole card:
// one persistent cooperative grid of (SMs x resident CTAs per SM) thread
// blocks, launched with cudaLaunchCooperativeKernel, walks the steps
// together.  Each step has three phases separated by grid.sync() (~1 us
// each):
//   (a) score: the live (block, beam, group of kGroup candidates) units of
//       the step are dealt round-robin over every warp of the grid, CTAs
//       first, so N=9 and N=72 both reach every SM.  A lane owns dims
//       d = lane + 32i; it loads the beam, ascale, qa and qb values of a dim
//       one iteration ahead and uses them for all kGroup candidates of its
//       unit (one load per scored element instead of four), and the
//       candidates' bits, normal map and score run as straight-line code
//       side by side (the erfinv tail, taken by ~0.3% of elements, is one
//       branch per group).  The normal map's log is the hardware
//       lg2.approx (the kernel is selection-only: faithful, not exact).
//       Scores go candidate-major to an (N, B*S) buffer that stays in L2,
//       so an element's index orders like its tile slot s*128 + b.
//   (b) select: one warp per live block holds the block's scores in
//       registers as unsigned order keys (B*S <= 32*kRegs; larger tiles
//       are read from the buffer) and makes the B picks without a
//       block-wide barrier: each pick is two redux.sync max reductions
//       (key, then lowest element), and only the owner of the picked slot
//       rescans its 24 keys, as a tree.
//   (c) carry: the B winning rows of every live block are regenerated in
//       kChunk-dim pieces, one warp each over the grid; the piece holding
//       dim 0 also carries the history row, the FNV hash and the next
//       step's beam key.
// Blocks are ordered by count (longest first, by the caller), so the live
// blocks of step t are the first live[t] of that order.  Every sum is taken
// in a fixed order and nothing uses float atomics: the same inputs give the
// same indices on every run.  Thread-block clusters were not taken: blocks
// of one step need no data from each other, only the carry's barrier, and
// a cluster of at most 8 (16 non-portable) CTAs per latent block would
// leave N=9 on 72-144 SMs.  The kernel allocates nothing (the caller passes
// scratch) and launches on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "streams.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;           // candidates scored together by a warp
constexpr int kRegs = 24;           // scores held per lane in the select phase
constexpr int kChunk = 256;         // dims of one carry unit (8 per lane)
constexpr int kCols = 128;          // selection tile columns (beams)
constexpr int kBig = 1 << 30;       // "no slot" sentinel, as in the Pallas kernel
constexpr float kLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421356f;

// jax.random.normal's bits -> normal map with XLA's single-precision
// erf_inv polynomial, in three parts so that a warp can interleave several
// candidates: u and l = log2(1 - u^2), then the central polynomial (taken
// when w = -ln(1 - u^2) < 5, i.e. l > kTailLg2), then the rare tail.
// 1 - u^2 comes from one fma (exact to rounding) and the log from the
// hardware lg2.approx (~2^-22 absolute error; the input is never below
// 2^-23, so flushing denormals changes nothing): eps moves by well under one
// float ulp of its value.  Faithful, not exact: the kernel only selects.
constexpr float kLn2 = 0.693147181f;
constexpr float kTailLg2 = -7.21347520f;  // -5 / ln 2

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (bits >> 9) as a float in [1, 2), minus 1, to (-1, 1).  JAX clamps u
// to >= kLo; the fma's exact value is >= kLo whenever x01 >= 0, so the
// clamp changes nothing and is left out.
__device__ __forceinline__ float uniform_u(uint32_t bits) {
  const float x01 = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaf(x01, 2.0f, kLo);
}

__device__ __forceinline__ float central_poly(float l) {
  const float w = fmaf(l, -kLn2, -2.5f);
  float p = 2.81022636e-08f;
  p = fmaf(p, w, 3.43273939e-07f);
  p = fmaf(p, w, -3.5233877e-06f);
  p = fmaf(p, w, -4.39150654e-06f);
  p = fmaf(p, w, 0.00021858087f);
  p = fmaf(p, w, -0.00125372503f);
  p = fmaf(p, w, -0.00417768164f);
  p = fmaf(p, w, 0.246640727f);
  return fmaf(p, w, 1.50140941f);
}

__device__ __forceinline__ float tail_poly(float l) {
  const float w = sqrtf(l * -kLn2) - 3.0f;
  float p = -0.000200214257f;
  p = fmaf(p, w, 0.000100950558f);
  p = fmaf(p, w, 0.00134934322f);
  p = fmaf(p, w, -0.00367342844f);
  p = fmaf(p, w, 0.00573950773f);
  p = fmaf(p, w, -0.0076224613f);
  p = fmaf(p, w, 0.00943887047f);
  p = fmaf(p, w, 1.00167406f);
  return fmaf(p, w, 2.83297682f);
}

// eps / sqrt(2) of G counters c0 + off[j] of one beam key, side by side:
// straight-line code for the bits, u, the log and the central polynomial
// of every counter, then one branch, taken by the few warps that hold a
// tail value.  `koff[j]` is k1 + off[j] * kGolden for fmix (the counter's
// hash input is c0 * kGolden + koff[j], one IMAD) and off[j] for threefry.
template <int STREAM, int G>
__device__ __forceinline__ void half_normals(uint32_t k1, uint32_t k2,
                                             uint32_t c0,
                                             const uint32_t (&koff)[G],
                                             float (&pu)[G]) {
  float u[G], l[G], p[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const uint32_t bits =
        STREAM == 0 ? fmix32(fmix32(c0 * kGolden + koff[j]) ^ k2)
                    : threefry_bits(k1, k2, c0 + koff[j]);
    u[j] = uniform_u(bits);
    l[j] = lg2_approx(fmaf(-u[j], u[j], 1.0f));
    p[j] = central_poly(l[j]);
  }
  float lmin = l[0];
#pragma unroll
  for (int j = 1; j < G; ++j) lmin = fminf(lmin, l[j]);
  if (lmin <= kTailLg2) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (l[j] <= kTailLg2) p[j] = tail_poly(l[j]);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) pu[j] = p[j] * u[j];
}

template <int STREAM>
__device__ __forceinline__ uint32_t counter_offset(uint32_t k1, uint32_t off) {
  return STREAM == 0 ? k1 + off * kGolden : off;
}

// A float's order as an unsigned key (NaN excluded), with -0 and +0 equal.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
constexpr uint32_t kNegInfKey = 0x007FFFFFu;  // order_key(-inf)

struct Args {
  const int* counts;        // (N,)
  const uint32_t* bkeys;    // (N, 2) raw block keys
  const float* qa;          // (N, P, D)
  const float* qb;
  const float* ascale;
  const int* order;         // (N,) blocks by count, longest first
  const int* live;          // (P,) blocks with count > t
  int* out;                 // (N, P), zero-filled by the caller
  float* beams;             // (N, 2, B, D)
  int* hist;                // (N, 2, B, P); step t writes entries <= t
  uint32_t* hashes;         // (N, 2, B)
  uint32_t* skeys;          // (N, 2, B, 2) beam stream keys of the step
  float* scores;            // (N, B*S)
  int* sel;                 // (N, 2, B): parents, then candidates
  int N, D, B, S, P;
};

// Phase (a): one unit = (live block, beam, kGroup candidates).  Scores are
// stored candidate-major, e = s*cols + b (cols = 1 at t == 0, else B), so
// the element order is the selection tile's slot order s*128 + b.
template <int STREAM>
__device__ __forceinline__ void score_phase(const Args& a, int t, int cur,
                                            int n_live, int gw, int n_gw,
                                            int lane) {
  const int D = a.D, B = a.B, S = a.S;
  const int cols = (t == 0) ? 1 : B;  // at t == 0 every beam is beam 0
  const int n_grp = (S + kGroup - 1) / kGroup;
  const int per_block = cols * n_grp;
  const int units = n_live * per_block;
  for (int u = gw; u < units; u += n_gw) {
    const int li = u / per_block;
    const int rem = u - li * per_block;
    const int b = rem / n_grp;
    const int s0 = (rem - b * n_grp) * kGroup;
    const int ns = min(kGroup, S - s0);
    const int nb = __ldg(a.order + li);
    const size_t row = ((size_t)nb * a.P + t) * D;
    const float* qa_t = a.qa + row;
    const float* qb_t = a.qb + row;
    const float* as_t = a.ascale + row;
    const size_t beam_row = ((size_t)nb * 2 + cur) * B + b;
    const float* beam = a.beams + beam_row * D;
    const uint32_t k1 = a.skeys[2 * beam_row], k2 = a.skeys[2 * beam_row + 1];
    const uint32_t base = (uint32_t)s0 * (uint32_t)D;
    float acc[kGroup];
    uint32_t koff[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      acc[j] = 0.0f;
      koff[j] = counter_offset<STREAM>(k1, (uint32_t)(j * D));
    }
    // The dim's four inputs are loaded one iteration ahead, so their
    // latency hides behind the candidates' arithmetic.
    float bm = 0.0f, as = 0.0f, qa = 0.0f, qb = 0.0f;
    if (lane < D) {
      if (t > 0) bm = beam[lane];
      as = __ldg(as_t + lane);
      qa = __ldg(qa_t + lane);
      qb = __ldg(qb_t + lane);
    }
    for (int d = lane; d < D; d += 32) {
      const int dn = d + 32;
      float nbm = 0.0f, nas = 0.0f, nqa = 0.0f, nqb = 0.0f;
      if (dn < D) {
        if (t > 0) nbm = beam[dn];
        nas = __ldg(as_t + dn);
        nqa = __ldg(qa_t + dn);
        nqb = __ldg(qb_t + dn);
      }
      // A candidate past S (a short last group) is computed, never stored.
      float pu[kGroup];
      half_normals<STREAM, kGroup>(k1, k2, base + (uint32_t)d, koff, pu);
      const float as2 = as * kSqrt2;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float x = fmaf(as2, pu[j], bm);
        acc[j] = fmaf(fmaf(qa, x, qb), x, acc[j]);
      }
      bm = nbm; as = nas; qa = nqa; qb = nqb;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (lane < ns) {
      float v = acc[0];
#pragma unroll
      for (int j = 1; j < kGroup; ++j) if (lane == j) v = acc[j];
      a.scores[(size_t)nb * B * S + (size_t)(s0 + lane) * cols + b] = v;
    }
  }
}

// A lane's best element over e = lane + 32 i < n as (order key, e): the
// largest score, ties to the lowest e (the lowest tile slot).  Key 0 means
// no element (past n, or NaN: NaN elements take no part and only raise the
// NaN flag).  Picked elements count as -inf.
//
// In registers (K > 0) the lane keeps its elements' keys and a bitmask of
// picked ones, and reduces them as a tree in which the right operand wins
// only by a larger key: its elements have the larger e, so ties keep the
// lower slot exactly as a serial scan would.
template <int K>
__device__ __forceinline__ void lane_best_regs(const uint32_t (&key)[K],
                                               uint32_t picked, int lane,
                                               uint32_t& bhi, int& be) {
  uint32_t h[K];
  int ix[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    h[i] = ((picked >> i) & 1u) ? kNegInfKey : key[i];
    ix[i] = i;
  }
#pragma unroll
  for (int w = 1; w < K; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < K; i += 2 * w) {
      if (h[i + w] > h[i]) { h[i] = h[i + w]; ix[i] = ix[i + w]; }
    }
  }
  bhi = h[0];
  be = bhi == 0u ? kBig : lane + 32 * ix[0];
}

// The same from the score buffer, where picked elements are stored as -inf.
__device__ __forceinline__ void lane_best_mem(const float* sc, int n,
                                              int lane, uint32_t& bhi,
                                              int& be, int& nan) {
  float bv = -INFINITY;
  be = kBig;
  nan = 0;
  for (int e = lane; e < n; e += 32) {
    const float x = sc[e];
    if (isnan(x)) nan = 1;
    else if (x > bv || be == kBig) { bv = x; be = e; }
  }
  bhi = be == kBig ? 0u : order_key(bv);
}

// Phase (b) for one block: the B picks of the Pallas tile's top-B, by one
// warp.  K > 0 keeps the lane's scores in registers (n <= 32 K) as order
// keys; K == 0 reads and marks them in the buffer.
template <int K>
__device__ __forceinline__ void select_block(float* sc, int t, int B, int S,
                                             int lane, int* parents,
                                             int* cands) {
  const int cols = (t == 0) ? 1 : B;
  const int n = S * cols;
  uint32_t key[K > 0 ? K : 1];
  uint32_t nan_mask = 0, picked = 0;
  uint32_t bhi;
  int be, nan = 0;
  if constexpr (K > 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int e = lane + 32 * i;
      const float x = e < n ? sc[e] : 0.0f;
      const bool is_nan = e < n && isnan(x);
      nan_mask |= (uint32_t)is_nan << i;
      key[i] = (e < n && !is_nan) ? order_key(x) : 0u;
    }
    lane_best_regs<K>(key, picked, lane, bhi, be);
  } else {
    lane_best_mem(sc, n, lane, bhi, be, nan);
  }
  const int S_pad = (S + 7) / 8 * 8;
  int min_invalid = kBig;  // lowest invalid slot s*128 + b
  if (t == 0) min_invalid = 1;
  else if (B < kCols) min_invalid = B;
  else if (S < S_pad) min_invalid = S * kCols;
  const float inv_cols = 1.0f / (float)cols;
  for (int k = 0; k < B; ++k) {
    // Warp argmax in two redux.sync: the largest key, then among the lanes
    // holding it the lowest element (largest ~e).  Key 0 is no element.
    const uint32_t whi = __reduce_max_sync(0xffffffffu, bhi);
    const uint32_t wlo = __reduce_max_sync(
        0xffffffffu, (bhi == whi && bhi != 0u) ? ~(uint32_t)be : 0u);
    int wf = kBig;
    if (whi != 0u) {
      const int we = (int)~wlo;
      const int ws = (int)(((float)we + 0.5f) * inv_cols);  // we / cols
      wf = ws * kCols + (we - ws * cols);
    }
    if (K > 0) nan = (nan_mask & ~picked) != 0u;
    int f;
    if (__any_sync(0xffffffffu, nan)) f = 0;     // NaN max: sentinel -> 0
    else if (whi <= kNegInfKey) f = min(wf, min_invalid);
    else f = wf;
    if (f >= kBig) f = 0;
    const int pb = f & (kCols - 1), ps = f >> 7;   // f >= 0, kCols = 128
    if (lane == 0) { parents[k] = pb; cands[k] = ps; }
    if (ps < S && pb < cols) {
      const int e = ps * cols + pb;
      if ((e & 31) == lane) {  // the owner marks the slot and rescans
        if constexpr (K > 0) {
          picked |= 1u << (e >> 5);
          lane_best_regs<K>(key, picked, lane, bhi, be);
        } else {
          sc[e] = -INFINITY;
          lane_best_mem(sc, n, lane, bhi, be, nan);
        }
      }
    }
    __syncwarp();
  }
}

// Phase (c): one unit = (live block, winning beam k, kChunk dims); the
// unit holding dim 0 also carries the history row, the hash and the next
// step's beam key.
template <int STREAM>
__device__ __forceinline__ void carry_phase(const Args& a, int t, int cur,
                                            int n_live, int gw, int n_gw,
                                            int lane) {
  const int D = a.D, B = a.B, P = a.P;
  const int nxt = cur ^ 1;
  const int n_chunk = (D + kChunk - 1) / kChunk;
  for (int u = gw; u < n_live * B * n_chunk; u += n_gw) {
    const int row = u / n_chunk;
    const int d0 = (u - row * n_chunk) * kChunk;
    const int li = row / B;
    const int k = row - li * B;
    const int nb = __ldg(a.order + li);
    const int* sel = a.sel + (size_t)nb * 2 * B;
    const int p = min(sel[k], B - 1);   // padding columns clamp
    const int c = sel[B + k];
    const size_t src_row = ((size_t)nb * 2 + cur) * B + p;
    const size_t dst_row = ((size_t)nb * 2 + nxt) * B + k;
    const uint32_t k1 = a.skeys[2 * src_row], k2 = a.skeys[2 * src_row + 1];
    const float* as_t = a.ascale + ((size_t)nb * P + t) * D;
    const float* src = a.beams + src_row * D;
    float* dst = a.beams + dst_row * D;
    const uint32_t base = (uint32_t)c * (uint32_t)D;
    constexpr int kPer = kChunk / 32;   // dims per lane
    uint32_t koff[kPer];
    float as[kPer], bm[kPer], pu[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = d0 + lane + 32 * i;
      koff[i] = counter_offset<STREAM>(k1, (uint32_t)(32 * i));
      as[i] = d < D ? __ldg(as_t + d) : 0.0f;
      bm[i] = (d < D && t > 0) ? src[d] : 0.0f;
    }
    half_normals<STREAM, kPer>(k1, k2, base + (uint32_t)(d0 + lane), koff,
                               pu);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = d0 + lane + 32 * i;
      if (d < D) dst[d] = fmaf(as[i], pu[i] * kSqrt2, bm[i]);
    }
    if (d0 > 0) continue;
    const int n_b = min(__ldg(a.counts + nb), P);
    const int* h_src = a.hist + src_row * P;
    int* h_dst = a.hist + dst_row * P;
    const bool last = (k == 0) && (t == n_b - 1);
    for (int j = lane; j <= t; j += 32) {   // entries past t stay zero
      const int h = (j == t) ? c : h_src[j];
      h_dst[j] = h;
      if (last) a.out[(size_t)nb * P + j] = h;
    }
    if (lane == 0) {
      const uint32_t h = (a.hashes[src_row] ^ (uint32_t)c) * kFnvPrime;
      a.hashes[dst_row] = h;
      if (t + 1 < n_b) {
        uint32_t s1, s2;
        fold_in(a.bkeys[2 * nb], a.bkeys[2 * nb + 1], (uint32_t)(t + 1),
                s1, s2);
        fold_in(s1, s2, h, a.skeys[2 * dst_row], a.skeys[2 * dst_row + 1]);
      }
    }
  }
}

template <int STREAM>
__global__ void __launch_bounds__(kThreads, 2) mega_beam_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Global warp ids run across CTAs first, so consecutive units land on
  // different SMs and a short step still reaches every SM.
  const int gw = warp * gridDim.x + blockIdx.x;
  const int n_gw = kWarps * gridDim.x;
  const int B = a.B, S = a.S;

  // Step 0: every beam has the empty history's hash and the same key.
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.N * B;
       i += gridDim.x * kThreads) {
    const int nb = i / B, b = i - nb * B;
    const size_t r = (size_t)nb * 2 * B + b;
    uint32_t s1, s2;
    fold_in(a.bkeys[2 * nb], a.bkeys[2 * nb + 1], 0u, s1, s2);
    fold_in(s1, s2, kFnvOffset, a.skeys[2 * r], a.skeys[2 * r + 1]);
    a.hashes[r] = kFnvOffset;
  }
  grid.sync();

  int cur = 0;
  for (int t = 0; t < a.P; ++t) {
    const int n_live = a.live[t];
    if (n_live == 0) break;
    score_phase<STREAM>(a, t, cur, n_live, gw, n_gw, lane);
    grid.sync();
    const bool in_regs = S * ((t == 0) ? 1 : B) <= 32 * kRegs;
    for (int li = gw; li < n_live; li += n_gw) {
      const int nb = __ldg(a.order + li);
      float* sc = a.scores + (size_t)nb * B * S;
      int* sel = a.sel + (size_t)nb * 2 * B;
      if (in_regs)
        select_block<kRegs>(sc, t, B, S, lane, sel, sel + B);
      else
        select_block<0>(sc, t, B, S, lane, sel, sel + B);
    }
    grid.sync();
    carry_phase<STREAM>(a, t, cur, n_live, gw, n_gw, lane);
    grid.sync();
    cur ^= 1;
  }
}

template <int STREAM>
cudaError_t occupancy(int* ctas_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, mega_beam_kernel<STREAM>, kThreads, 0);
}

}  // namespace

// Launch planning (bound with ctypes): the card's SM count, the resident
// CTAs per SM of the stream's kernel, the threads per CTA, the candidates a
// warp scores together, and whether the card takes cooperative launches.
// Returns the CUDA error code.
extern "C" int mega_beam_occupancy(int stream_kind, int* sms,
                                   int* ctas_per_sm, int* threads,
                                   int* group, int* cooperative) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch,
                               dev);
  if (e == cudaSuccess)
    e = stream_kind == 0 ? occupancy<0>(ctas_per_sm)
                         : occupancy<1>(ctas_per_sm);
  *threads = kThreads;
  *group = kGroup;
  return (int)e;
}

// C entry point (bound with ctypes).  stream_kind: 0 = fmix, 1 = threefry.
// n_ctas is the cooperative grid (SMs x resident CTAs per SM, from
// mega_beam_occupancy).  Returns the CUDA error code of the launch.
extern "C" int mega_beam_launch(const void* counts, const void* bkeys,
                                const void* qa, const void* qb,
                                const void* ascale, const void* order,
                                const void* live, void* out, void* beams,
                                void* hist, void* hashes, void* skeys,
                                void* scores, void* sel, int N, int D, int B,
                                int S, int P, int n_ctas, int stream_kind,
                                void* stream) {
  if (N <= 0) return 0;
  if (B < 1 || B > kCols || S < 1 || S > kCols || D < 1 || P < 1
      || n_ctas < 1)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(counts), static_cast<const uint32_t*>(bkeys),
         static_cast<const float*>(qa), static_cast<const float*>(qb),
         static_cast<const float*>(ascale), static_cast<const int*>(order),
         static_cast<const int*>(live), static_cast<int*>(out),
         static_cast<float*>(beams), static_cast<int*>(hist),
         static_cast<uint32_t*>(hashes), static_cast<uint32_t*>(skeys),
         static_cast<float*>(scores), static_cast<int*>(sel),
         N, D, B, S, P};
  void* params[] = {&a};
  const void* fn = stream_kind == 0
      ? reinterpret_cast<const void*>(mega_beam_kernel<0>)
      : reinterpret_cast<const void*>(mega_beam_kernel<1>);
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(n_ctas), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
