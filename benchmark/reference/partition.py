"""Frozen copy of rec_tpu_torch/coding/partition.py for the benchmark's reference
(the replay has to give the program's bits; the copy may not change
with the program).

KL partitioning and latent-block split/merge (port of
rec_tpu/coding/partition.py).

A latent's total KL is cut into <= Omega-nat chunks by auxiliary variables
whose variance ratios follow the reference's power law or a learned table.
``split``/``merge`` flatten a latent, apply a pseudo-random permutation that
hangs off the transmitted seed, and cut it into equal ``block_size`` blocks;
the ragged tail is padded with target == coder dims, which are coding no-ops.

The variance schedule is computed on the host, in float32, once per
partition count, and then moved to the device: it is (P,) scalars per block,
and computing it on the host makes it the same bits on every device.  It
copies the bits ``rec_tpu`` gets on XLA-CPU, so a file written by either
package decodes bit for bit in the other:

* the power law is the C library's ``powf``, which XLA-CPU calls for
  ``jnp.power`` (numpy's float32 power is another implementation);
* ``jnp.cumprod`` lowers to a reduce-window that XLA rewrites into a
  two-level scan (``_cumprod_parts``); and LLVM contracts the final
  ``1 - prefix * carry`` into one fused multiply-add.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import rng
from .gauss import GaussianParams, kl_divergence
from .threefry_normal import fma_f32_exact, sqrt_f32

# ratio(i) = (i + 1) ** AUX_RATIO_POWER_LAW   (ref coder.py:16,218-220).
AUX_RATIO_POWER_LAW = -0.7864636765648174
# Tile length of XLA's reduce-window rewrite of a cumulative product.
_SCAN_TILE = 16


@functools.lru_cache(maxsize=1)
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


@functools.lru_cache(maxsize=32)
def _power_law(n: int) -> np.ndarray:
    """float32 (i + 1) ** AUX_RATIO_POWER_LAW for i < n, by ``powf``
    (callers round n up to a power of two, so the table is reused)."""
    powf = _powf()
    p = float(np.float32(AUX_RATIO_POWER_LAW))
    out = np.array([powf(float(i + 1), p) for i in range(n)], np.float32)
    out.flags.writeable = False
    return out


def aux_variance_ratio(index, ratios: Optional[Sequence[float]] = None
                       ) -> np.ndarray:
    """Variance ratio for auxiliary variable ``index`` (host, float32).

    The power law, or a learned table with the power law past its end."""
    index = np.asarray(index)
    top = int(index.max()) if index.size else 0
    power = _power_law(1 << top.bit_length())[index]
    if ratios is None:
        return power
    table = np.asarray(ratios, np.float32)
    idx = np.clip(index, 0, table.shape[0] - 1)
    return np.where(index >= table.shape[0], power, table[idx])


def _cumprod_seq(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    acc = np.float32(1.0)
    for i, v in enumerate(x):
        acc = np.float32(acc * v)
        out[i] = acc
    return out


def _cumprod_parts(x: np.ndarray):
    """XLA-CPU's evaluation of a float32 cumulative product as (prefix,
    carry), cumprod = prefix * carry.  Up to ``_SCAN_TILE`` elements the
    product is sequential (carry 1).  Longer inputs are padded with ones to
    tiles of ``_SCAN_TILE``; each tile's sequential prefix is multiplied by
    the carry of the tiles before it, which is the inclusive cumulative
    product of the tile totals, itself evaluated by this rule."""
    n = x.shape[0]
    if n <= _SCAN_TILE:
        return _cumprod_seq(x), np.ones(n, np.float32)
    tiles = -(-n // _SCAN_TILE)
    padded = np.ones(tiles * _SCAN_TILE, np.float32)
    padded[:n] = x
    pre = np.stack([_cumprod_seq(row)
                    for row in padded.reshape(tiles, _SCAN_TILE)])
    p2, c2 = _cumprod_parts(pre[:, -1].copy())
    carry = np.concatenate([np.ones(1, np.float32), (p2 * c2)[:-1]])
    return pre.reshape(-1)[:n], np.repeat(carry, _SCAN_TILE)[:n]


@functools.lru_cache(maxsize=4096)
def _schedule_cached(count: int, max_partitions: int,
                     ratios: Optional[tuple]):
    t = np.arange(max_partitions)
    i = np.maximum(count - 1 - t, 0)
    r = aux_variance_ratio(i, ratios).astype(np.float32)
    r = np.where(t < count, r, np.float32(0.0)).astype(np.float32)
    one_minus = np.maximum(np.float32(1.0) - r, np.float32(0.0))
    pre, carry = _cumprod_parts(one_minus)
    cp = (pre * carry).astype(np.float32)
    prod_before = np.concatenate([np.ones(1, np.float32), cp[:-1]])
    w = (r * prod_before).astype(np.float32)
    c_after = fma_f32_exact(torch.from_numpy(-pre), torch.from_numpy(carry),
                            torch.ones(max_partitions)).numpy()
    w.flags.writeable = False
    c_after.flags.writeable = False
    return w, c_after


def partition_schedule(count: int, max_partitions: int,
                       ratios: Optional[Sequence[float]] = None):
    """Closed-form auxiliary-variance schedule for one block, on the host.

    The recurrence aux_var_t = r_{i_t} (p_var - cum_var_t), i_t = count-1-t
    telescopes to aux_var_t = p_var * w_t with

        w_t = r_{i_t} * prod_{u<t} (1 - r_{i_u}),

    Returns float32 numpy ``(w, c_after)`` of shape (max_partitions,): the
    per-step variance weights (0 for t >= count) and the cumulative variance
    fraction after each step, bitwise equal to ``rec_tpu``'s on XLA-CPU.
    """
    key = None if ratios is None else tuple(float(r) for r in
                                            np.asarray(ratios, np.float32))
    return _schedule_cached(int(count), int(max_partitions), key)


def schedule_table(counts, max_partitions: int, ratios=None, *, device):
    """(w, c_after) as (N, P) float32 tensors on ``device`` for per-block
    ``counts``."""
    counts = np.asarray(torch.as_tensor(counts).cpu()).reshape(-1)
    rows = [partition_schedule(int(c), max_partitions, ratios)
            for c in counts]
    if rows:
        w = np.stack([r[0] for r in rows])
        c_after = np.stack([r[1] for r in rows])
    else:
        w = c_after = np.zeros((0, max_partitions), np.float32)
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(c_after).to(device))


def replay_contract(coders: GaussianParams, w: torch.Tensor,
                    eps: torch.Tensor) -> torch.Tensor:
    """The replay's float chain for N blocks, shared by both coders:

        sample = p_scale * sum_t sqrt(w_t) * eps_t + loc,

    with schedule weights ``w`` (N, P) and the steps' standard-normal rows
    ``eps`` (N, P, D).  The partition sum is taken in a fixed sequential
    order, one fused multiply-add per step, and the scale and loc are
    applied as one fused multiply-add: XLA-CPU contracts ``rec_tpu``'s
    pinned multiplies and the adds after them inside the jitted coder
    (beam search's pinned scan and the importance coder's
    ``einsum("np,npd->nd")`` alike), so the sample is ``rec_tpu``'s bits
    for any prior.  Every float operation is a basic IEEE operation in its
    own eager kernel, so the result is the same bits on the CPU and on the
    GPU."""
    N, P, D = eps.shape
    sqrt_w = sqrt_f32(w)
    acc = torch.zeros((N, D), dtype=torch.float32, device=eps.device)
    for t in range(P):
        acc = fma_f32_exact(sqrt_w[:, t, None], eps[:, t], acc)
    return fma_f32_exact(coders.scale, acc, coders.loc)


def num_partitions(total_kl: torch.Tensor, kl_per_partition: float
                   ) -> torch.Tensor:
    """ceil(KL / Omega) as int32, clamped to >= 1.  A non-finite KL maps to
    the int32-safe ceiling 2^30 (inf) or 1 (NaN) instead of an undefined
    float -> int cast."""
    n = torch.ceil(total_kl / kl_per_partition)
    n = torch.nan_to_num(n, nan=0.0, posinf=2.0 ** 30, neginf=0.0)
    return torch.clamp(n, 1.0, 2.0 ** 30).to(torch.int32)


class BlockSplit(NamedTuple):
    """Static split geometry for a flattened latent of ``num_dims`` dims."""

    num_dims: int
    block_size: int
    num_blocks: int
    padded: int


def plan_split(num_dims: int, block_size: Optional[int]) -> BlockSplit:
    if block_size is None or block_size >= num_dims:
        return BlockSplit(num_dims, num_dims, 1, num_dims)
    num_blocks = -(-num_dims // block_size)
    return BlockSplit(num_dims, block_size, num_blocks,
                      num_blocks * block_size)


def split_permutation(root: torch.Tensor, plan: BlockSplit) -> torch.Tensor:
    """``jax.random.permutation(split_key(root), num_dims)`` exactly."""
    return split_permutations(root[None], plan)[0]


def split_permutations(roots: torch.Tensor, plan: BlockSplit
                       ) -> torch.Tensor:
    """The split permutations of a batch of root keys (B, 2) as (B, n),
    each ``jax.random.permutation(split_key(root), num_dims)`` exactly.

    JAX's ``_shuffle``: ceil(3 ln n / ln(2^32 - 1)) rounds, each splitting
    the key and stably sorting by fresh 32-bit ``random.bits`` keys."""
    n = plan.num_dims
    dev = roots.device
    key = rng.split_key(roots)
    x = torch.arange(n, dtype=torch.int64, device=dev).expand(
        roots.shape[0], n)
    num_rounds = int(np.ceil(3 * np.log(max(1, n))
                             / np.log(np.iinfo(np.uint32).max)))
    ctr = torch.arange(n, dtype=torch.int64, device=dev)
    for _ in range(num_rounds):
        key, subkey = rng.split(key)
        sort_keys = rng.stream_bits(subkey, ctr, "threefry")
        order = torch.sort(sort_keys, dim=-1, stable=True).indices
        x = torch.gather(x, 1, order)
    return x


def split_coders(coders: GaussianParams, plan: BlockSplit,
                 perms: torch.Tensor) -> GaussianParams:
    """Split B distributions (leading axis), each with its own permutation
    (B, n), into one flat (B * num_blocks, block_size) block axis,
    image-major, padding with standard-normal dims (target == coder there,
    so they are exact coding no-ops)."""
    B = perms.shape[0]
    pad = plan.padded - plan.num_dims

    def one(x, fill):
        x = torch.gather(x.reshape(B, -1), 1, perms)
        if pad:
            x = torch.cat([x, x.new_full((B, pad), fill)], dim=1)
        return x.reshape(B * plan.num_blocks, plan.block_size)

    return GaussianParams(one(coders.loc, 0.0), one(coders.scale, 1.0))


def merge_batch(block_samples: torch.Tensor, shape, plan: BlockSplit,
                perms: torch.Tensor) -> torch.Tensor:
    """Inverse of ``split_coders``: drop padding, un-permute, reshape
    (B * num_blocks, block_size) -> (B, *shape)."""
    B = perms.shape[0]
    flat = block_samples.reshape(B, -1)[:, : plan.num_dims]
    out = torch.empty_like(flat).scatter_(1, perms, flat)
    return out.reshape((B,) + tuple(shape))


def block_kl(target: GaussianParams, coder: GaussianParams) -> torch.Tensor:
    """Per-block total KL in nats; blocks on the leading axis."""
    return torch.sum(kl_divergence(target, coder), dim=-1)


__all__ = ["AUX_RATIO_POWER_LAW", "BlockSplit", "aux_variance_ratio",
           "block_kl", "merge_batch", "num_partitions", "partition_schedule",
           "plan_split", "replay_contract", "schedule_table", "split_coders",
           "split_permutation", "split_permutations"]
