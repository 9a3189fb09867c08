"""KL-partitioned coder driven by the rejection sampler (port of
rec_tpu/coding/rejection_coder.py).

The rejection sampler needs host float64 acceptance buffers per partition
(``rejection.py``), so the partition chain runs as a host loop with eager
device steps, op for op as ``rec_tpu`` runs it eagerly: the auxiliary
variance, target and coder of each step, the coded (or, in update mode,
freely drawn) auxiliary sample, and the conditioning on it.  Decode is
index arithmetic on the shared streams.  Every step is a basic IEEE
operation (square roots ``sqrt_f32``), so encode and decode give
``rec_tpu``'s float32 bits on the CPU and on the GPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import rng
from .gauss import (GaussianParams, auxiliary_target, conditional_coder,
                    conditional_target)
from .partition import aux_variance_ratio
from .rejection import (RejectionSampler, RejectionSamplerConfig,
                        decode_rejection_sample, kl_f32)
from .utils import CodingError
from ..ops.threefry_normal import sqrt_f32

UPDATE_TAG = 0xf1   # the update pass's free auxiliary draw of a step key


@dataclasses.dataclass
class RejectionCoder:
    kl_per_partition: float = 3.0
    sampler_config: RejectionSamplerConfig = dataclasses.field(
        default_factory=RejectionSamplerConfig)
    aux_variance_ratios: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        self.sampler = RejectionSampler(self.sampler_config)

    def _ratio(self, i: int) -> float:
        """float32 variance ratio of auxiliary variable ``i`` (0 is the
        last, full one): the learned table's entry, or the power law."""
        if self.aux_variance_ratios is not None:
            if i >= len(self.aux_variance_ratios):
                raise CodingError(
                    f"KL needs ratio index {i} but the learned table has "
                    f"only {len(self.aux_variance_ratios)} entries; refit "
                    "with higher-KL data or use extrapolation")
            return float(np.float32(self.aux_variance_ratios[i]))
        return float(aux_variance_ratio(i))

    def num_partitions(self, target: GaussianParams, coder: GaussianParams
                       ) -> int:
        """max(ceil(KL / Omega), 1), the KL summed in XLA-CPU's order."""
        return max(int(math.ceil(kl_f32(target, coder)
                                 / self.kl_per_partition)), 1)

    def _aux_var(self, coder: GaussianParams, i: int) -> torch.Tensor:
        ratio = torch.tensor(self._ratio(i), dtype=torch.float32,
                             device=coder.loc.device)
        return ratio * coder.var

    def encode_block(self, target: GaussianParams, coder: GaussianParams,
                     seed: int, update_sampler: bool = False
                     ) -> Tuple[List[int], torch.Tensor]:
        """Partition chain with per-partition rejection coding.  Returns
        (indices, sample); with ``update_sampler`` the sampler's
        acceptance statistics are updated instead and no index is coded
        (each step's auxiliary sample is drawn freely from
        fold_in(step key, 0xf1))."""
        indices: List[int] = []
        for index, _, coder in self.encode_steps(target, coder, seed,
                                                 update_sampler):
            if index is not None:
                indices.append(index)
        return indices, coder.loc

    def encode_steps(self, target: GaussianParams, coder: GaussianParams,
                     seed: int, update_sampler: bool = False
                     ) -> Iterator[Tuple[Optional[int], GaussianParams,
                                         GaussianParams]]:
        """``encode_block``'s partition steps one at a time: yields each
        step's index (None with ``update_sampler``) and the target and
        coder conditioned on its auxiliary sample."""
        n = self.num_partitions(target, coder)
        dev = target.loc.device
        # Keys are derived on the host (a single key's threefry evaluation
        # is ~170 tiny kernels on a card); the draws run on the device.
        root = rng.root_key(seed, device="cpu")
        for t in range(n):
            aux_var = self._aux_var(coder, n - 1 - t)
            aux_t = auxiliary_target(target, coder, aux_var)
            aux_c = GaussianParams(torch.zeros_like(coder.loc),
                                   sqrt_f32(aux_var))
            key = rng.step_key(root, t)
            index = None
            if update_sampler:
                self.sampler.update(aux_t, aux_c, key)
                eps = rng.normal_stream(rng.fold_in(key, UPDATE_TAG).to(dev),
                                        tuple(aux_t.loc.shape))
                aux_sample = aux_t.loc + aux_t.scale * eps
            else:
                index, aux_sample = self.sampler.coded_sample(aux_t, aux_c,
                                                              key)
            target = conditional_target(target, coder, aux_var, aux_sample)
            coder = conditional_coder(coder, aux_var, aux_sample)
            yield index, target, coder

    def decode_block(self, coder: GaussianParams, indices: List[int],
                     seed: int) -> torch.Tensor:
        n = len(indices)
        dev = coder.loc.device
        root = rng.root_key(seed, device="cpu")
        for t, index in enumerate(indices):
            aux_var = self._aux_var(coder, n - 1 - t)
            eps = decode_rejection_sample(self.sampler.cfg,
                                          rng.step_key(root, t).to(dev),
                                          int(index), coder.loc.shape[-1])
            coder = conditional_coder(coder, aux_var, sqrt_f32(aux_var) * eps)
        return coder.loc

    def get_codelength(self, indices: List[int]) -> float:
        """Nats, from the fitted acceptance probabilities (needs update
        passes first)."""
        return sum(self.sampler.get_codelength(i) for i in indices)
