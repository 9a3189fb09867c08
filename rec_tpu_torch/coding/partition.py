"""KL partitioning and latent-block split/merge (port of
rec_tpu/coding/partition.py).

A latent's total KL is cut into <= Omega-nat chunks by auxiliary variables
whose variance ratios follow the reference's power law or a learned table.
``split``/``merge`` flatten a latent, apply a pseudo-random permutation that
hangs off the transmitted seed, and cut it into equal ``block_size`` blocks;
the ragged tail is padded with target == coder dims, which are coding no-ops.

The variance schedule is computed on the host, in float32, once per
partition count, and then moved to the device: it is (P,) scalars per block,
and computing it on the host makes it the same bits on every device.
(On-device ``torch.pow`` and ``torch.cumprod`` round differently from each
other's devices and from XLA.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import rng
from .gauss import GaussianParams, kl_divergence

# ratio(i) = (i + 1) ** AUX_RATIO_POWER_LAW   (ref coder.py:16,218-220).
AUX_RATIO_POWER_LAW = -0.7864636765648174


def aux_variance_ratio(index, ratios: Optional[Sequence[float]] = None
                       ) -> np.ndarray:
    """Variance ratio for auxiliary variable ``index`` (host, float32).

    The power law, or a learned table with the power law past its end."""
    index = np.asarray(index)
    power = np.power(index.astype(np.float32) + np.float32(1.0),
                     np.float32(AUX_RATIO_POWER_LAW))
    if ratios is None:
        return power
    table = np.asarray(ratios, np.float32)
    idx = np.clip(index, 0, table.shape[0] - 1)
    return np.where(index >= table.shape[0], power, table[idx])


@functools.lru_cache(maxsize=4096)
def _schedule_cached(count: int, max_partitions: int,
                     ratios: Optional[tuple]):
    t = np.arange(max_partitions)
    i = np.maximum(count - 1 - t, 0)
    r = aux_variance_ratio(i, ratios).astype(np.float32)
    r = np.where(t < count, r, np.float32(0.0)).astype(np.float32)
    one_minus = np.maximum(np.float32(1.0) - r, np.float32(0.0))
    cp = np.cumprod(one_minus, dtype=np.float32)
    prod_before = np.concatenate([np.ones(1, np.float32), cp[:-1]])
    w = (r * prod_before).astype(np.float32)
    c_after = (np.float32(1.0) - cp).astype(np.float32)
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
    fraction after each step.  The product is taken sequentially in float32.
    """
    key = None if ratios is None else tuple(float(r) for r in
                                            np.asarray(ratios, np.float32))
    return _schedule_cached(int(count), int(max_partitions), key)


def schedule_table(counts, max_partitions: int, ratios=None,
                   device="cpu"):
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
    """``jax.random.permutation(split_key(root), num_dims)`` exactly.

    JAX's ``_shuffle``: ceil(3 ln n / ln(2^32 - 1)) rounds, each splitting
    the key and stably sorting by fresh 32-bit ``random.bits`` keys."""
    n = plan.num_dims
    key = rng.split_key(root)
    x = torch.arange(n, dtype=torch.int64, device=root.device)
    num_rounds = int(np.ceil(3 * np.log(max(1, n))
                             / np.log(np.iinfo(np.uint32).max)))
    ctr = torch.arange(n, dtype=torch.int64, device=root.device)
    for _ in range(num_rounds):
        key, subkey = rng.split(key)
        sort_keys = rng.stream_bits(subkey, ctr, "threefry")
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x


def _ravel(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1)


def split_pair(target: GaussianParams, coder: GaussianParams,
               plan: BlockSplit, perm: torch.Tensor):
    """Split (target, coder) into (num_blocks, block_size) blocks, padding
    with standard-normal target == coder dims (exact coding no-ops)."""
    t = split_coder(target, plan, perm)
    c = split_coder(coder, plan, perm)
    return t, c


def split_coder(coder: GaussianParams, plan: BlockSplit, perm: torch.Tensor
                ) -> GaussianParams:
    """Decode-side split of one distribution."""
    loc = _ravel(coder.loc)[perm]
    scale = _ravel(coder.scale)[perm]
    pad = plan.padded - plan.num_dims
    if pad:
        loc = torch.cat([loc, loc.new_zeros(pad)])
        scale = torch.cat([scale, scale.new_ones(pad)])
    shp = (plan.num_blocks, plan.block_size)
    return GaussianParams(loc.reshape(shp), scale.reshape(shp))


def merge(block_samples: torch.Tensor, shape, plan: BlockSplit,
          perm: torch.Tensor) -> torch.Tensor:
    """Inverse of split: drop padding, un-permute, reshape."""
    flat = block_samples.reshape(-1)[: plan.num_dims]
    out = torch.empty_like(flat)
    out[perm] = flat
    return out.reshape(shape)


def block_kl(target: GaussianParams, coder: GaussianParams) -> torch.Tensor:
    """Per-block total KL in nats; blocks on the leading axis."""
    return torch.sum(kl_divergence(target, coder), dim=-1)


__all__ = ["AUX_RATIO_POWER_LAW", "BlockSplit", "aux_variance_ratio",
           "block_kl", "merge", "num_partitions", "partition_schedule",
           "plan_split", "schedule_table", "split_coder", "split_pair",
           "split_permutation"]
