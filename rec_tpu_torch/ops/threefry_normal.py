"""Threefry bits and the bits -> standard-normal map, in eager PyTorch.

Port of ``rec_tpu/ops/threefry_normal.py``.  Two layers:

* **Integer streams** (``threefry2x32``, ``random_bits``): uint32 arithmetic
  held in int64 tensors and masked to 32 bits after every operation that can
  carry out of the low word.  torch has no usable uint32 tensors, and ``>>``
  on a signed int32 is arithmetic, not logical; in int64 every value stays
  non-negative, so shifts are logical.  Multiplications by 32-bit constants
  are split into 16-bit halves so no product leaves the int64 range.  These
  are bit-exact to ``jax.random`` by construction.

* **The normal map** (``bits_to_normal``): jax.random.normal's mantissa fill
  -> uniform on (nextafter(-1, 0), 1) -> sqrt(2) * erfinv(u), with XLA's
  single-precision erfinv polynomial.  It feeds the decode replay, so it has
  to give the same bits on every device: it is built only from IEEE-exact
  basic operations (+ - * /, compares, ``where``, bit casts), each a
  separate eager op, so nothing is fused or contracted differently on the CPU
  and on CUDA.  float32 sqrt is rounded by hand (``sqrt_f32``); ``log1p`` is
  written out in float64 (range reduction on the float's bits plus an atanh
  series); the Horner steps, which XLA contracts into fused multiply-adds,
  are emulated in float64 and rounded to float32 once per step.  torch.erfinv / torch.log1p are not used: they
  differ from XLA and between devices.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))

# XLA's single-precision erf_inv coefficients (w < 5 and w >= 5 branches).
_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
_BIG = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_SMALL = tuple(float(np.float32(c)) for c in _SMALL)
_BIG = tuple(float(np.float32(c)) for c in _BIG)

# fdlibm's split of ln 2: k * _LN2_HI is exact for |k| < 2^20.
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_SQRT2 = float(np.sqrt(2.0))
# 2 * atanh(s) = 2 s sum_j s^(2j) / (2j + 1); 13 terms reach float64
# precision for |s| <= 3 - 2 sqrt(2).
_ATANH = tuple(1.0 / (2 * j + 1) for j in range(13))


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a Python-int constant c,
    without leaving the int64 range."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1):
    """Unrolled 20-round threefry2x32 on uint32 values held in int64
    tensors (or Python ints); arguments broadcast."""
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    x = [(x0 + ks[0]) & M32, (x1 + ks[1]) & M32]

    def rounds(x, rots):
        for r in rots:
            a = (x[0] + x[1]) & M32
            x = [a, a ^ _rotl(x[1], r)]
        return x

    x = rounds(x, _ROT0)
    x = [(x[0] + ks[1]) & M32, (x[1] + ks[2] + 1) & M32]
    x = rounds(x, _ROT1)
    x = [(x[0] + ks[2]) & M32, (x[1] + ks[0] + 2) & M32]
    x = rounds(x, _ROT0)
    x = [(x[0] + ks[0]) & M32, (x[1] + ks[1] + 3) & M32]
    x = rounds(x, _ROT1)
    x = [(x[0] + ks[1]) & M32, (x[1] + ks[2] + 4) & M32]
    x = rounds(x, _ROT0)
    return (x[0] + ks[2]) & M32, (x[1] + ks[0] + 5) & M32


def random_bits(k1, k2, counters: torch.Tensor) -> torch.Tensor:
    """jax.random.bits for flat positions ``counters``: the partitionable
    counter layout, bits[i] = out0 ^ out1 of threefry(key, (0, i))."""
    o0, o1 = threefry2x32(k1, k2, torch.zeros_like(counters), counters)
    return o0 ^ o1


def _log1p_f64(z: torch.Tensor) -> torch.Tensor:
    """log(1 + z) in float64 for z in (-1, 0], from basic operations only.

    For 1 + z >= sqrt(1/2) the atanh identity log1p(z) = 2 atanh(z / (2 + z))
    needs no reduction.  Below that, y = 1 + z is exact (|z| > 0.29), and
    y = m * 2^k with m in [sqrt(1/2), sqrt(2)) is read off the float's bits;
    m - 1 is then exact as well.
    """
    y = 1.0 + z
    bits = y.view(torch.int64)
    k = ((bits >> 52) & 0x7FF) - 1023
    m = ((bits & 0x000FFFFFFFFFFFFF) | 0x3FF0000000000000).view(torch.float64)
    big = m >= _SQRT2
    m = torch.where(big, m * 0.5, m)
    k = torch.where(big, k + 1, k)
    reduce = y < (1.0 / _SQRT2)
    f = torch.where(reduce, m - 1.0, z)
    kf = torch.where(reduce, k, torch.zeros_like(k)).to(torch.float64)
    s = f / (2.0 + f)
    s2 = s * s
    p = torch.full_like(s, _ATANH[-1])
    for c in _ATANH[-2::-1]:
        p = p * s2 + c
    return kf * _LN2_HI + (2.0 * s * p + kf * _LN2_LO)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of x >= 0 on every device.

    torch's CPU float32 sqrt is not always correctly rounded (it disagreed
    with CUDA's on 135 of the 2^23 normal-map inputs), so the float64 root
    is rounded to float32 and then fixed against the exact squares of the
    two neighbouring midpoints (25 significant bits, exact in float64)."""
    xd = x.double()
    r = torch.sqrt(xd).float()
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    dn = torch.nextafter(r, torch.zeros_like(r))
    mid_hi = (r.double() + up.double()) * 0.5
    mid_lo = (r.double() + dn.double()) * 0.5
    r = torch.where(mid_hi * mid_hi <= xd, up, r)
    return torch.where(mid_lo * mid_lo > xd, dn, r)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """float32 fused multiply-add a * b + c with one rounding: the float32
    product is exact in float64."""
    return (a.double() * b.double() + c).float()


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erf_inv (its ErfInv32 polynomial) for
    float32 x in (-1, 1): w = -log1p(-x^2), a 9-term polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3 (w >= 5), times x."""
    w = (-_log1p_f64(-(x * x).double())).float()
    small = w < 5.0
    ws = torch.where(small, w - 2.5, sqrt_f32(w) - 3.0)
    p = torch.where(small, torch.full_like(ws, _SMALL[0]),
                    torch.full_like(ws, _BIG[0]))
    for cs, cb in zip(_SMALL[1:], _BIG[1:]):
        p = torch.where(small, _fma_f32(p, ws, cs), _fma_f32(p, ws, cb))
    return p * x


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) -> float32 standard normal, jax.random.normal's
    mapping.  The same function on every device, bit for bit."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    x01 = fbits.view(torch.float32) - 1.0
    # (1 - LO) rounds to exactly 2.0 in float32, so the product is exact.
    u = torch.clamp(x01 * 2.0 + _LO, min=_LO)
    return erfinv_f32(u) * _SQRT2_F32

