"""Pseudo sample generator: fake a large proposal buffer from few true
draws (port of rec_tpu/coding/sample_generator.py).

``n_true`` true coder samples are recombined per dimension: each dimension
is assigned to one of ``n_groups`` groups, and pseudo-sample j takes, for
every dimension in group g, the true sample ``assign[g, j]``.  The ratios
group per-dimension log-ratios with a one-hot matmul.  Everything is a pure
function of (key, shapes), so encode and decode regenerate the same
buffers.  The draws are ``rec_tpu``'s bit for bit (``jax.random.split``,
``normal`` and ``randint``), so ``pseudo_sample`` equals ``rec_tpu``'s
exactly; ``pseudo_ratios`` sums in another order than XLA's matmul and
agrees to float32 rounding (tests hold it to rtol 1e-5, atol 1e-4).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import rng
from .gauss import GaussianParams, log_density_ratio


@dataclasses.dataclass(frozen=True)
class PseudoSampleGeneratorConfig:
    buffer_size: int = 10000
    n_true_samples: int = 50
    n_groups: int = 50


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    threefry bit streams from split(key) and JAX's map of them into
    [minval, maxval), uint32 arithmetic wrapping modulo 2^32.  Returns
    int64 values."""
    n = 1
    for s in shape:
        n *= s
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = rng.split(key)
    hi = rng.stream_bits(k1, ctr, "threefry")
    lo = rng.stream_bits(k2, ctr, "threefry")
    span = max(maxval - minval, 1)
    m = (1 << 16) % span
    mult = ((m * m) & rng.M32) % span     # uint32: the square wraps too
    off = (((hi % span) * mult) & rng.M32) + (lo % span)
    off = (off & rng.M32) % span
    return (minval + off).reshape(tuple(shape))


def _draws(cfg: PseudoSampleGeneratorConfig, coder: GaussianParams,
           key: torch.Tensor):
    D = coder.loc.shape[-1]
    k_samp, k_group, k_assign = (rng.fold_in(key, i) for i in range(3))
    eps = rng.normal_stream(k_samp, (cfg.n_true_samples, D))
    true = coder.loc + coder.scale * eps                        # (T, D)
    groups = randint(k_group, (D,), 0, cfg.n_groups)
    assign = randint(k_assign, (cfg.n_groups, cfg.buffer_size), 0,
                     cfg.n_true_samples)
    return true, groups, assign


def pseudo_ratios(cfg: PseudoSampleGeneratorConfig, target: GaussianParams,
                  coder: GaussianParams, key: torch.Tensor) -> torch.Tensor:
    """Log t/p ratios of all pseudo samples, shape (buffer_size,)."""
    true, groups, assign = _draws(cfg, coder, key)
    per_dim = log_density_ratio(true, target, coder)            # (T, D)
    onehot = F.one_hot(groups, cfg.n_groups).to(per_dim.dtype)  # (D, G)
    group_ratios = per_dim @ onehot                             # (T, G)
    # ratio of pseudo-sample j = sum_g group_ratios[assign[g, j], g]
    gathered = torch.gather(group_ratios.T, 1, assign)          # (G, B)
    return torch.sum(gathered, dim=0)


def pseudo_sample(cfg: PseudoSampleGeneratorConfig, coder: GaussianParams,
                  key: torch.Tensor, index: int) -> torch.Tensor:
    """Materialize pseudo sample ``index`` (used by encode and decode)."""
    true, groups, assign = _draws(cfg, coder, key)
    true_idx = assign[groups, index]                            # (D,)
    return true[true_idx, torch.arange(true.shape[1], device=key.device)]
