// Quadratic candidate scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel rec_tpu/ops/beam_score.py::_score_pallas (Pallas,
// reached through rec_tpu.ops.score_candidates).  For each candidate row n of
// x (N x D, float32, row-major) it computes
//   out[n] = sum_d (a[d] * x[n,d] + b[d]) * x[n,d] + c_sum[0],
// the log density ratio log q(x) - log p(x) of two diagonal Gaussians in the
// quadratic form of coding/gauss.py::quadratic_coeffs.  The Pallas kernel
// broadcast each score over 128 lanes to satisfy Mosaic's output tiling;
// here the output is simply (N,) float32.
//
// What bounds it.  Bytes: each x element is read once for two FMAs.  At the
// paper coder (B*S = 720 rows, D = 1024) x is 720 * 1024 * 4 B = 2.95 MB,
// 0.88 us at the H100 SXM's 3.35 TB/s (data sheet, 700 W), against 2.9
// MFLOP (0.04 us at 67 TFLOP/s).  Reading it at that rate needs nearly the
// whole tile in flight at once: 3.35 TB/s times ~0.7 us of DRAM latency is
// ~2.3 MB.  A launch of this size also pays the card's fixed cost of a
// launch: on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py measured
// 3.8 us of device time per launch at (720, 1024) with the L2 flushed,
// against a 1.0 us floor for a one-element kernel (23% of the byte bound).
//
// Design.  A CTA of 256 threads owns R consecutive rows (R a template
// constant: the largest of 8, 4, 2, 1 that still gives at least one CTA per
// SM, so N = 720 on 132 SMs takes R = 4 and 180 CTAs).  Thread t owns the
// float4 t of each 1024-wide chunk of D: it loads its float4 of a and b once
// per chunk, issues the float4 loads of all R rows (streaming, __ldcs)
// before any arithmetic, and accumulates each row with two FMAs per element.
// For D <= 1024 a thread reads a and b once in all, not once per row, and
// every load of the tile is in flight together (R x 16 B per thread).  Rows
// whose bases are not 16-byte aligned, or D % 4 != 0, take the scalar path
// (vec = 0) with the same structure.  Each row's partial sums reduce by warp
// shuffles, then across the 8 warps in shared memory in a fixed order, so
// two launches give the same bits; the sum's order differs from a
// sequential one, so a tolerance, not bitwise equality, holds it against the
// plain version.  Unlike the TPU kernel, any D works: the D % 128 gate of
// rec_tpu was a TPU tiling rule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

template <int R>
__global__ void __launch_bounds__(kThreads)
    beam_score_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c_sum,
                      float* __restrict__ out, int n, int d, int vec) {
  __shared__ float part[R][kWarps];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const float* xr[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    live[r] = row0 + r < n;
    xr[r] = x + static_cast<size_t>(live[r] ? row0 + r : row0) * d;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  int tail = 0;
  if (vec) {
    const int d4 = d >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int i = tid; i < d4; i += kThreads) {
      const float4 av = __ldg(a4 + i);
      const float4 bv = __ldg(b4 + i);
      float4 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = live[r] ? __ldcs(reinterpret_cast<const float4*>(xr[r]) + i)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = fmaf(fmaf(av.x, v[r].x, bv.x), v[r].x, acc[r]);
        acc[r] = fmaf(fmaf(av.y, v[r].y, bv.y), v[r].y, acc[r]);
        acc[r] = fmaf(fmaf(av.z, v[r].z, bv.z), v[r].z, acc[r]);
        acc[r] = fmaf(fmaf(av.w, v[r].w, bv.w), v[r].w, acc[r]);
      }
    }
    tail = d4 << 2;
  }
  for (int i = tail + tid; i < d; i += kThreads) {
    const float ai = __ldg(a + i);
    const float bi = __ldg(b + i);
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = live[r] ? __ldcs(xr[r] + i) : 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = fmaf(fmaf(ai, v[r], bi), v[r], acc[r]);
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) part[r][warp] = s;
  }
  __syncthreads();
  if (tid < R && row0 + tid < n) {
    float s = part[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[tid][w];
    out[row0 + tid] = s + __ldg(c_sum);
  }
}

// SM count of the current card, read once per card.
cudaError_t sm_count(int* sms) {
  static int cache[kMaxDevices];  // 0 until read; every writer stores the same
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *sms = cache[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices) cache[dev] = *sms;
  return e;
}

// Rows per CTA: the largest of 8, 4, 2, 1 that leaves at least one CTA per
// SM; 1 when N is below the SM count.
int rows_per_cta(int n, int sms) {
  for (int r = 8; r > 1; r >>= 1)
    if ((n + r - 1) / r >= sms) return r;
  return 1;
}

template <int R>
void launch(const float* x, const float* a, const float* b,
            const float* c_sum, float* out, int n, int d, int vec,
            cudaStream_t stream) {
  beam_score_kernel<R><<<(n + R - 1) / R, kThreads, 0, stream>>>(
      x, a, b, c_sum, out, n, d, vec);
}

}  // namespace

// Rows per CTA and CTAs of a launch over n rows on the current card.
// Returns the CUDA error code.
extern "C" int beam_score_grid(int n, int* rows, int* ctas) {
  int sms;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  *rows = rows_per_cta(n, sms);
  *ctas = (n + *rows - 1) / *rows;
  return 0;
}

// Launch on ``stream``; returns the CUDA error of the launch (0 on success).
// ``vec`` != 0 asserts that x, a and b are 16-byte aligned and d % 4 == 0.
extern "C" int beam_score_launch(const float* x, const float* a,
                                 const float* b, const float* c_sum,
                                 float* out, int n, int d, int vec,
                                 void* stream) {
  if (n <= 0) return 0;
  int sms;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_cta(n, sms)) {
    case 8: launch<8>(x, a, b, c_sum, out, n, d, vec, s); break;
    case 4: launch<4>(x, a, b, c_sum, out, n, d, vec, s); break;
    case 2: launch<2>(x, a, b, c_sum, out, n, d, vec, s); break;
    default: launch<1>(x, a, b, c_sum, out, n, d, vec, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
