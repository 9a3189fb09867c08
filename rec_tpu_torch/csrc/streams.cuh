// The coder's counter-based streams on the device, shared by the kernels
// that derive keys or draw candidates (mega_beam.cu, replay.cu).
//
// Bit for bit the functions of rec_tpu_torch/coding/rng.py and
// ops/threefry_normal.py (and so jax.random's): threefry2x32 with 20
// rounds, fold_in(key, data) = threefry2x32(key, (0, data)), murmur3's
// fmix32 finaliser, and the FNV-1a history hash's constants.

#pragma once

#include <stdint.h>

constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kGolden = 0x9E3779B9u;

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

// The threefry stream's bits of one counter: jax.random.bits' partitionable
// layout, out0 ^ out1 of threefry2x32(key, (0, counter)).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint32_t ctr) {
  uint32_t o0, o1;
  threefry2x32(k1, k2, 0u, ctr, o0, o1);
  return o0 ^ o1;
}

// The fmix stream's bits of one counter: two fmix32 rounds keyed by
// (k1, k2) over counter * kGolden (rng.fmix_bits).
__device__ __forceinline__ uint32_t fmix_bits(uint32_t k1, uint32_t k2,
                                              uint32_t ctr) {
  return fmix32(fmix32(ctr * kGolden + k1) ^ k2);
}
