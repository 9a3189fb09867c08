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
  to give the same bits on every device, and the same bits as ``rec_tpu`` on
  XLA-CPU: it copies the operation sequence XLA-CPU compiles for
  ``lax.erf_inv`` (its elemental ``log1p`` — a Cephes rational for small
  arguments, XLA's own float32 ``log`` polynomial otherwise — then the
  erfinv polynomial), including which multiply-adds LLVM contracts into
  fused multiply-adds.  Every step is an IEEE-exact basic operation (+ - *
  /, compares, ``where``, bit casts) in its own eager op, so nothing is fused
  differently on the CPU and on CUDA.  A fused multiply-add is emulated in
  float64 and rounded to float32 once; division runs in float64 and is
  rounded once (innocuous double rounding); float32 sqrt is rounded by hand
  (``sqrt_f32``).  The result equals XLA-CPU's on all 2^23 inputs the map
  can receive (``tests/test_torch_rng.py``).  torch.erfinv / torch.log1p are
  not used: they differ from XLA and between devices.
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

# XLA-CPU's elemental log1p: below |z| = sqrt(2) - 1 a Cephes rational
# z - z^2/2 + z^3 N(z)/D(z), above it log(1 + z).
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG1P_DEN = (15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
# XLA-CPU's float32 log (Cephes logf): y = f 2^e with f in [sqrt(1/2),
# sqrt(2)), a degree-9 polynomial in r = f - 1 evaluated as three
# interleaved Horner chains, and ln 2 split as 0.693359375 - 2.12194440e-4.
_LOG_C = (0.07037683576345444, -0.11514610052108765, -0.12420140951871872,
          0.14249323308467865, 0.2000071406364441, -0.24999994039535522,
          0.11676998436450958, -0.16668057441711426, 0.3333333134651184)
_LN2_HI_F32 = 0.693359375
_LN2_LO_F32 = -0.00021219444170128554
_SQRT_HALF_F32 = 0.7071067690849304
_FLT_MIN = 1.1754943508222875e-38
# XLA-CPU's float32 exp (Cephes expf): x clamped to [-87.8, 88.8],
# n = floor(x log2(e) + 1/2) clamped to [-127, 127], r = x - n ln 2 with
# ln 2 split as for the log, a degree-5 polynomial, times 2^n.
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E_F32 = 1.4426950216293335
_EXP_C = (0.00019875691214110702, 0.001398199936375022,
          0.008333452045917511, 0.04166579619050026, 0.1666666567325592,
          0.5)


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


def _fma_f32(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add a * b + c with one rounding.  The float32
    product is exact in float64; the float64 sum is then rounded to float32.
    That double rounding could in principle differ from a true fma, but on
    every input the normal map can receive it does not (checked against
    XLA-CPU on all 2^23 of them)."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    return (a * b + torch.as_tensor(c, dtype=torch.float64)).float()


def fma_f32_exact(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                  ) -> torch.Tensor:
    """float32 fused multiply-add a * b + c, correctly rounded for any
    float32 inputs: the float64 sum of the exact product and c is rounded
    to odd (its error from TwoSum decides the last bit) before the float32
    rounding, which makes the double rounding exact."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    z = s - p
    err = (p - (s - z)) + (cd - z)
    bits = s.view(torch.int64)
    even = (bits & 1) == 0
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & even, bits + toward, bits)
    return bits.view(torch.float64).float()


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 log for y > 0, op by op: multiply-adds that LLVM
    contracts are ``_fma_f32``; every other step rounds to float32."""
    y = torch.clamp(y, min=_FLT_MIN)
    bits = y.view(torch.int32)
    f = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    e = ((bits >> 23) - 126).float()
    low = f < _SQRT_HALF_F32
    r = (f - 1.0) + torch.where(low, f, torch.zeros_like(f))
    e = e - low.float()
    r2 = r * r
    r3 = r2 * r
    a = _fma_f32(_fma_f32(r, _LOG_C[0], _LOG_C[1]), r, _LOG_C[6])
    b = _fma_f32(_fma_f32(r, _LOG_C[2], _LOG_C[3]), r, _LOG_C[7])
    c = _fma_f32(_fma_f32(r, _LOG_C[4], _LOG_C[5]), r, _LOG_C[8])
    q = _fma_f32(_fma_f32(a, r3, b), r3, c)
    q = _fma_f32(q, r3, e * _LN2_LO_F32)
    return ((r - r2 * 0.5) + q) + e * _LN2_HI_F32


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 exp, op by op, the same bits on every device: the
    multiply-adds LLVM contracts are ``fma_f32_exact``, every other step
    rounds to float32.  NaN stays NaN, exp(x) overflows to +inf from
    x ~ 88.72 and XLA-CPU's flush-to-zero makes subnormal results 0."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    half = torch.full_like(x, 0.5)
    fx = torch.floor(fma_f32_exact(x, torch.full_like(x, _LOG2E_F32), half))
    fx = torch.clamp(fx, -127.0, 127.0)
    for c in (_LN2_HI_F32, _LN2_LO_F32):
        x = fma_f32_exact(fx, torch.full_like(x, -c), x)
    y = torch.full_like(x, _EXP_C[0])
    for c in _EXP_C[1:]:
        y = fma_f32_exact(y, x, torch.full_like(x, c))
    y = fma_f32_exact(y, x * x, x) + 1.0
    n = torch.where(torch.isnan(fx), 0.0, fx).to(torch.int32)
    out = y * ((n + 127) << 23).view(torch.float32)
    return torch.where(out < _FLT_MIN, 0.0, out)


def _log1p_f32(z: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 log1p (its elemental IR emitter), op by op."""
    z2 = z * z
    den = torch.ones_like(z)
    for d in _LOG1P_DEN:
        den = _fma_f32(den, z, d)
    num = torch.full_like(z, _LOG1P_NUM[0])
    for n in _LOG1P_NUM[1:]:
        num = _fma_f32(num, z, n)
    ratio = (num.double() / den.double()).float()
    small = z + _fma_f32(z2, -0.5, (z * z2) * ratio)
    return torch.where(torch.abs(z) < _LOG1P_SMALL, small,
                       _log_f32(z + 1.0))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of x >= 0 on every device.

    torch's CPU float32 sqrt is not always correctly rounded (it disagreed
    with CUDA's on 135 of the 2^23 normal-map inputs), so the float64 root
    is rounded to float32 and then fixed against the exact squares of the
    two neighbouring midpoints (25 significant bits, exact in float64).
    Its gradient is ``torch.sqrt``'s: the rounding is a constant."""
    xd = x.detach().double()
    r = torch.sqrt(xd).float()
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    dn = torch.nextafter(r, torch.zeros_like(r))
    mid_hi = (r.double() + up.double()) * 0.5
    mid_lo = (r.double() + dn.double()) * 0.5
    r = torch.where(mid_hi * mid_hi <= xd, up, r)
    r = torch.where(mid_lo * mid_lo > xd, dn, r)
    if x.requires_grad:
        s = torch.sqrt(x)
        r = s + (r - s).detach()   # exact: r and s differ by an ulp at most
    return r


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erf_inv (its ErfInv32 polynomial) for
    float32 x in (-1, 1): w = -log1p(-x^2), a 9-term polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3 (w >= 5), times x."""
    w = -_log1p_f32(x * -x)
    small = w < 5.0
    ws = torch.where(small, w - 2.5, sqrt_f32(w) - 3.0)
    p = torch.where(small, torch.full_like(ws, _SMALL[0]),
                    torch.full_like(ws, _BIG[0]))
    for cs, cb in zip(_SMALL[1:], _BIG[1:]):
        p = torch.where(small, _fma_f32(p, ws, cs), _fma_f32(p, ws, cb))
    return p * x


def bits_to_erfinv(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) -> erfinv(u) of jax.random.normal's uniform
    u, before its multiply by sqrt(2): XLA folds that constant into a
    following multiply (``coding/rejection.py`` needs the factor alone).
    The same function on every device, bit for bit."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    x01 = fbits.view(torch.float32) - 1.0
    # (1 - LO) rounds to exactly 2.0 in float32, so the product is exact.
    u = torch.clamp(x01 * 2.0 + _LO, min=_LO)
    return erfinv_f32(u)


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) -> float32 standard normal, jax.random.normal's
    mapping.  The same function on every device, bit for bit."""
    return bits_to_erfinv(bits) * _SQRT2_F32

