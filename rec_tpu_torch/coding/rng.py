"""Counter-based RNG discipline for the codec (port of rec_tpu/coding/rng.py).

Encoder and decoder share only ``(seed, indices)`` and regenerate identical
proposal streams.  Every stream is addressed by a (root key, structured
counter) pair through ``fold_in`` on threefry keys:

    root(seed)
      -> fold_in(SPLIT_TAG)                  : the block split permutation
      -> fold_in(BLOCK_TAG) -> fold_in(b)    : per latent-block subtree
           -> fold_in(t)                     : per KL-partition step
                -> fold_in(history_hash)     : per beam candidate stream,
                   candidate s = counter rows [s*D, (s+1)*D) of that key

A key is an int64 tensor of shape (..., 2) holding the two uint32 words of
``jax.random.key_data``; every function here is bit-exact to its
``rec_tpu.coding.rng`` counterpart and vectorises over leading key axes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops.threefry_normal import (M32, _SQRT2_F32, _log_f32,
                                   bits_to_erfinv, fma_f32_exact, mul32,
                                   random_bits, threefry2x32)
from ..utils.profiling import span

SPLIT_TAG = 0x51137
BLOCK_TAG = 0xb10c
POOL_TAG = 0x900d

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_GOLDEN = 0x9E3779B9
_FMIX_C1, _FMIX_C2 = 0x85EBCA6B, 0xC2B2AE35    # murmur3's fmix32
_TINY_F32 = float(np.finfo(np.float32).tiny)
_TABLE_BITS = 23          # the normal map reads bits >> 9 only


def _as_u32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def root_key(seed, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` key words for a 32-bit seed: (0, seed),
    on the card unless the CPU is asked for."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=resolve_device(device))


def root_keys(seeds, device="cuda") -> torch.Tensor:
    """``root_key`` of each seed, as (B, 2)."""
    seeds = [int(s) & M32 for s in seeds]
    return torch.tensor([[0, s] for s in seeds], dtype=torch.int64,
                        device=resolve_device(device)).reshape(len(seeds), 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry2x32(key, (0, data)); ``data``
    broadcasts against the key's leading axes."""
    data = _as_u32(data, key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(key: torch.Tensor):
    """``jax.random.split(key, 2)`` (partitionable layout): the new keys are
    threefry2x32(key, (0, i)) for i = 0, 1."""
    return fold_in(key, 0), fold_in(key, 1)


def split_key(root: torch.Tensor) -> torch.Tensor:
    return fold_in(root, SPLIT_TAG)


def block_key(root: torch.Tensor, block_id) -> torch.Tensor:
    return fold_in(fold_in(root, BLOCK_TAG), block_id)


def step_key(bkey: torch.Tensor, step) -> torch.Tensor:
    return fold_in(bkey, step)


def beam_stream_key(skey: torch.Tensor, history_hash) -> torch.Tensor:
    return fold_in(skey, history_hash)


def pool_key(skey: torch.Tensor) -> torch.Tensor:
    return fold_in(skey, POOL_TAG)


def fnv_init(shape, device) -> torch.Tensor:
    return torch.full(shape, FNV_OFFSET, dtype=torch.int64, device=device)


def fnv_step(h: torch.Tensor, index) -> torch.Tensor:
    """One FNV-1a step folding a chosen candidate index into a history
    hash."""
    return mul32(h ^ _as_u32(index, h.device), FNV_PRIME)


def as_i32(x) -> torch.Tensor:
    """uint32 values (held in int64) as the int32 tensor of the same bits."""
    x = torch.as_tensor(x)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int32 (the uint32's bits)."""
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * (_FMIX_C1 - (1 << 32))      # the int32 of the constant
    x = x ^ ((x >> 13) & 0x7FFFF)
    x = x * (_FMIX_C2 - (1 << 32))
    return x ^ ((x >> 16) & 0xFFFF)


def fmix_golden_i32(counters: torch.Tensor) -> torch.Tensor:
    """counters * 0x9E3779B9 mod 2^32 as int32: the fmix stream's
    key-independent first step, which a caller may compute once per
    counter layout."""
    return as_i32(mul32(counters.to(torch.int64), _GOLDEN))


def fmix_bits_i32(k1: torch.Tensor, k2: torch.Tensor,
                  golden: torch.Tensor) -> torch.Tensor:
    """The fmix stream's bits as int32 (the uint32's two's complement),
    from int32 key words and ``fmix_golden_i32(counters)``.  int32
    multiplies and adds wrap modulo 2^32 and right shifts are masked to
    logical ones, so each step is the uint32 operation: half the bytes of
    uint32-in-int64 arithmetic, and one operation per multiply."""
    x = _fmix32(golden + k1)
    return _fmix32(x ^ k2)


def fmix_bits(k1, k2, counters: torch.Tensor) -> torch.Tensor:
    """Counter-based uniform bits: two fmix32 rounds keyed by (k1, k2), as
    uint32 values in int64 (``rec_tpu``'s ``fmix_bits``)."""
    return fmix_bits_i32(as_i32(k1), as_i32(k2),
                         fmix_golden_i32(counters)).to(torch.int64) & M32


def _bits(k1, k2, counters: torch.Tensor, stream: str) -> torch.Tensor:
    if stream == "fmix":
        return fmix_bits_i32(as_i32(k1), as_i32(k2),
                             fmix_golden_i32(counters))
    if stream == "threefry":
        return random_bits(k1, k2, counters)
    raise ValueError(f"unknown stream {stream!r}")


def stream_bits(key: torch.Tensor, counters: torch.Tensor,
                stream: str) -> torch.Tensor:
    """The bits of each key's stream at all ``counters``: key (..., 2) and
    counters (*C) give (..., *C), uint32 values in int64 for "threefry"
    and their int32 for "fmix" (``_bits_to_normal_f32`` reads both)."""
    extra = (1,) * counters.dim()
    k1 = key[..., 0].reshape(key.shape[:-1] + extra)
    k2 = key[..., 1].reshape(key.shape[:-1] + extra)
    return _bits(k1, k2, counters, stream)


def normal_stream(key: torch.Tensor, shape, stream: str = "threefry"
                  ) -> torch.Tensor:
    """iid standard normals of a static ``shape`` from ``key`` (..., 2):
    ``jax.random.normal`` for "threefry" (partitionable counter layout),
    the fmix counter hash for "fmix".  Returns (..., *shape) float32."""
    n = math.prod(shape) if shape else 1
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    out = _bits_to_normal_f32(stream_bits(key, ctr, stream))
    return out.reshape(key.shape[:-1] + tuple(shape))


def normal_stream_row(key: torch.Tensor, row, chunk_rows: int, dim: int,
                      stream: str = "threefry") -> torch.Tensor:
    """Row ``row`` of ``normal_stream(key, (chunk_rows, dim))``, generated
    from its counter offset (row*dim .. row*dim + dim) for both streams —
    the partitionable threefry layout addresses rows the same way fmix
    does.  ``row`` broadcasts against the key's leading axes; returns
    (..., dim)."""
    del chunk_rows  # rows are addressed directly
    row = torch.as_tensor(row, dtype=torch.int64, device=key.device)
    ctr = (row.unsqueeze(-1) * dim
           + torch.arange(dim, dtype=torch.int64, device=key.device))
    return _bits_to_normal_f32(_bits(key[..., 0:1], key[..., 1:2], ctr,
                                     stream))


def _bits_to_normal_f32(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.normal's bits -> float32-normal tail, shared by every
    stream: the map of ops/threefry_normal.py (the same bits on every
    device), read from its table at one gather per normal.  ``bits`` are
    uint32 values in int64, or the int32 of the same bits."""
    return normal_table(bits.device)[table_index(bits)]


def table_index(bits: torch.Tensor) -> torch.Tensor:
    """The normal map's table index of uint32 bits (in int64, or the int32
    of the same bits): the 23 bits ``bits >> 9``."""
    return ((bits >> 9) & ((1 << _TABLE_BITS) - 1)).to(torch.int32)


@functools.lru_cache(maxsize=8)
def erfinv_table(device: torch.device) -> torch.Tensor:
    """``bits_to_erfinv`` of every 23-bit mantissa (2^23 float32, 32 MiB):
    the normal map before its multiply by sqrt(2).  Built on ``device`` by
    the map itself, 2^20 entries at a time, once per device (a set-up
    span)."""
    step = 1 << 20
    with span("setup.normal_table", card=device, setup=True):
        parts = [bits_to_erfinv(torch.arange(i, i + step, dtype=torch.int64,
                                             device=device) << 9)
                 for i in range(0, 1 << _TABLE_BITS, step)]
        return torch.cat(parts)


@functools.lru_cache(maxsize=8)
def normal_table(device: torch.device) -> torch.Tensor:
    """``bits_to_normal`` of every 23-bit mantissa (2^23 float32, 32 MiB):
    the normal map reads only ``bits >> 9``, so ``normal_table[bits >> 9]``
    IS the map, bit for bit (``_bits_to_normal_f32`` reads it):
    ``erfinv_table`` times sqrt(2), as ``bits_to_normal`` computes it."""
    return erfinv_table(device) * _SQRT2_F32


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=minval, maxval=maxval)`` for
    keys (..., 2): u = the threefry bits' mantissa fill minus 1, then
    max(minval, u * (maxval - minval) + minval) with the scale taken in
    float32 and the multiply-add fused, as XLA-CPU compiles it (one
    rounding).  Where the scale is 1, as for maxval 1 and a minval below
    2^-24, the fused form is u + minval, which is what runs then.
    Returns (..., n) float32."""
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    bits = stream_bits(key, ctr, "threefry")
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(lo))
    if scale == 1.0:
        out = u + lo
    else:
        out = fma_f32_exact(u, *(torch.tensor(v, dtype=torch.float32,
                                              device=u.device)
                                 for v in (scale, lo)))
    return torch.clamp(out, min=lo)


def split_chain(key: torch.Tensor, n: int) -> torch.Tensor:
    """The subkeys of ``n`` successive ``key, sub = split(key)`` steps
    (the key chain of a ``lax.scan`` that splits its carried key once per
    step), as (n, 2) on the key's device.  The carried chain runs on the
    host in Python integers, one threefry evaluation per step; the
    subkeys are then derived in one vectorised call."""
    k0, k1 = (int(v) for v in key.tolist())
    chain = []
    for _ in range(n):
        chain.append((k0, k1))
        k0, k1 = threefry2x32(k0, k1, 0, 0)
    keys = torch.tensor(chain, dtype=torch.int64,
                        device=key.device).reshape(n, 2)
    return fold_in(keys, 1)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (its default "low" mode) for keys
    (..., 2): -log(-log(u)) of threefry uniforms u on [tiny, 1), with
    XLA-CPU's float32 log.  Returns (..., n) float32."""
    return -_log_f32(-_log_f32(uniform(key, n, _TINY_F32)))
