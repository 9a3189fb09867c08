// Quadratic candidate scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel rec_tpu/ops/beam_score.py::_score_pallas (Pallas,
// reached through rec_tpu.ops.score_candidates).  For each candidate row n of
// x (N x D, float32, row-major) it computes
//   out[n] = sum_d (a[d] * x[n,d] + b[d]) * x[n,d] + c_sum[0],
// the log density ratio log q(x) - log p(x) of two diagonal Gaussians in the
// quadratic form of _quadratic_coeffs.  The Pallas kernel broadcast each
// score over 128 lanes to satisfy Mosaic's output tiling; here the output is
// simply (N,) float32.
//
// Design.  One warp per row: lanes stride over the row in 16-byte float4
// loads when the rows are 16-byte aligned (D % 4 == 0 and aligned bases),
// with a masked scalar tail otherwise; a and b are read through the
// read-only cache (__ldg) and are shared by every row, so they stay in L1/L2.
// Each lane accumulates in float32 and the warp reduces with shuffles, so
// the sum's order differs from a sequential one (a tolerance, not bitwise,
// holds it against the plain version).  Unlike the TPU kernel, any D works:
// the D % 128 gate of rec_tpu was a TPU tiling rule.
//
// What bounds it.  Bytes: each x element is read once for 4 flops.  At the
// paper coder (B*S = 720 rows, D = 1024) x is 720 * 1024 * 4 B = 2.95 MB,
// 0.88 us at 3.35 TB/s, against 2.9 MFLOP (0.04 us at 67 TFLOP/s), so at
// this size the launch latency (a few us) dominates the kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void beam_score_kernel(const float* __restrict__ x,
                                  const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ c_sum,
                                  float* __restrict__ out, int n, int d,
                                  int vec) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  float acc = 0.0f;
  int tail = 0;
  if (vec) {
    const int d4 = d >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int i = lane; i < d4; i += 32) {
      const float4 v = x4[i];
      const float4 av = __ldg(a4 + i);
      const float4 bv = __ldg(b4 + i);
      acc += (av.x * v.x + bv.x) * v.x;
      acc += (av.y * v.y + bv.y) * v.y;
      acc += (av.z * v.z + bv.z) * v.z;
      acc += (av.w * v.w + bv.w) * v.w;
    }
    tail = d4 << 2;
  }
  for (int i = tail + lane; i < d; i += 32) {
    const float v = xr[i];
    acc += (__ldg(a + i) * v + __ldg(b + i)) * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc + __ldg(c_sum);
}

}  // namespace

// Launch on ``stream``; returns the CUDA error of the launch (0 on success).
// ``vec`` != 0 asserts that x, a and b are 16-byte aligned and d % 4 == 0.
extern "C" int beam_score_launch(const float* x, const float* a,
                                 const float* b, const float* c_sum,
                                 float* out, int n, int d, int vec,
                                 void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  beam_score_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, a, b, c_sum, out, n, d, vec);
  return static_cast<int>(cudaGetLastError());
}
