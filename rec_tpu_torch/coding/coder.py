"""High-level coder API: arbitrary-shaped latents -> per-block index streams
(port of rec_tpu/coding/coder.py, beam-search family).

The latent is flattened in C order (HWC for the models' NHWC latents),
permuted by the seed's split permutation, and cut into equal blocks; the
per-block codec runs on all blocks at once.  ``encode`` reports the decode
replay of the chosen indices as the sample, so ``encode().sample ==
decode(...)`` bit for bit, on the CPU and on the GPU alike.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import beam_search, rng
from .gauss import GaussianParams
from .partition import (block_kl, merge, plan_split, split_coder,
                        split_pair, split_permutation)


class CodedLatent(NamedTuple):
    indices: torch.Tensor  # (num_blocks, max_partitions) int32
    counts: torch.Tensor   # (num_blocks,) int32 — partitions per block
    sample: torch.Tensor   # original latent shape


class _BlockCoder:
    """Shared split/merge plumbing; subclasses provide the block codec."""

    block_size: Optional[int]
    max_partitions: int
    kl_per_partition: float
    aux_variance_ratios = None

    def _encode_blocks(self, targets, coders, bkeys, ratios):
        raise NotImplementedError

    def _decode_blocks(self, coders, indices, counts, bkeys, ratios):
        raise NotImplementedError

    def _ratios(self):
        return self.aux_variance_ratios

    def _setup(self, numel: int, seed: int, device):
        plan = plan_split(numel, self.block_size)
        root = rng.root_key(seed, device=device)
        perm = split_permutation(root, plan)
        blocks = torch.arange(plan.num_blocks, dtype=torch.int64,
                              device=device)
        return plan, perm, rng.block_key(root, blocks)

    def required_partitions(self, target: GaussianParams,
                            coder: GaussianParams, seed: int = 0) -> int:
        """Host-side helper: max ceil(KL/Omega) over blocks, for choosing a
        large-enough static ``max_partitions``.  Always in [1, 2^24]: a
        non-finite or huge KL reports the cap, a zero KL reports 1."""
        plan, perm, _ = self._setup(target.loc.numel(), seed,
                                    target.loc.device)
        t, c = split_pair(target, coder, plan, perm)
        kls = block_kl(t, c).double().cpu().numpy()
        kls = np.nan_to_num(kls, nan=np.inf, posinf=np.inf, neginf=0.0)
        need = float(np.max(np.ceil(kls / self.kl_per_partition)))
        return int(max(1.0, min(need, 2.0 ** 24)))

    def encode(self, target: GaussianParams, coder: GaussianParams,
               seed: int) -> CodedLatent:
        shape = target.loc.shape
        plan, perm, bkeys = self._setup(target.loc.numel(), seed,
                                        target.loc.device)
        t, c = split_pair(target, coder, plan, perm)
        # The encoder embeds the decoder: the block codec reports the decode
        # replay of its indices as the sample, so it is not replayed again.
        coded = self._encode_blocks(t, c, bkeys, self._ratios())
        return CodedLatent(coded.indices, coded.count,
                           merge(coded.sample, shape, plan, perm))

    def decode(self, coder: GaussianParams, indices: torch.Tensor,
               counts: torch.Tensor, seed: int) -> torch.Tensor:
        shape = coder.loc.shape
        dev = coder.loc.device
        plan, perm, bkeys = self._setup(coder.loc.numel(), seed, dev)
        c = split_coder(coder, plan, perm)
        samples = self._decode_blocks(
            c, torch.as_tensor(indices, device=dev),
            torch.as_tensor(counts, device=dev), bkeys, self._ratios())
        return merge(samples, shape, plan, perm)


@dataclasses.dataclass(frozen=True)
class BeamSearchCoder(_BlockCoder):
    """The paper's production coder (ref beam_search_coder.py)."""

    kl_per_partition: float = 3.0
    n_beams: int = 20
    extra_samples: float = 1.2
    block_size: Optional[int] = 1000
    max_partitions: int = 24
    shared_pool: bool = False
    stream: str = "fmix"
    aux_variance_ratios: Optional[tuple] = None

    def _cfg(self):
        return beam_search.BeamSearchConfig(
            kl_per_partition=self.kl_per_partition, n_beams=self.n_beams,
            extra_samples=self.extra_samples,
            max_partitions=self.max_partitions,
            shared_pool=self.shared_pool, stream=self.stream)

    @property
    def n_samples(self) -> int:
        return self._cfg().n_samples

    def _encode_blocks(self, targets, coders, bkeys, ratios):
        return beam_search.encode_blocks(self._cfg(), targets, coders, bkeys,
                                         ratios)

    def _decode_blocks(self, coders, indices, counts, bkeys, ratios):
        return beam_search.decode_blocks(self._cfg(), coders, indices,
                                         counts, bkeys, ratios)
