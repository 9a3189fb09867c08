"""High-level coder API: arbitrary-shaped latents -> per-block index streams
(port of rec_tpu/coding/coder.py).

Two coder families, as in ``rec_tpu``: ``GaussianCoder`` (KL-partitioned
auxiliary chain + importance sampler) and ``BeamSearchCoder`` (the paper's
production coder).

The latent is flattened in C order (HWC for the models' NHWC latents),
permuted by the seed's split permutation, and cut into equal blocks; the
per-block codec runs on all blocks at once.  ``encode`` reports the decode
replay of the chosen indices as the sample, so ``encode().sample ==
decode(...)`` bit for bit, on the CPU and on the GPU alike.

``encode_batch``/``decode_batch`` code B latents with B seeds through ONE
block-codec call: each image is split with its own seed (split permutation
and block keys exactly as ``encode``), and all images' blocks are
concatenated into one flat block axis — the torch form of ``rec_tpu``'s
custom-vmap rule (``rec_tpu/ops/mega_beam.py:266-304``), so one kernel
launch encodes the whole batch.  Blocks are independent, so image i's
indices, counts and sample are those of ``encode`` with ``seeds[i]``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from . import beam_search, importance, rng
from .gauss import GaussianParams
from .partition import (block_kl, merge_batch, plan_split, split_coders,
                        split_permutations)
from .utils import xla_sum_f32
from ..utils.profiling import span


class CodedLatent(NamedTuple):
    indices: torch.Tensor  # (num_blocks, max_partitions) int32
    counts: torch.Tensor   # (num_blocks,) int32 — partitions per block
    sample: torch.Tensor   # original latent shape


def _batch1(p: GaussianParams) -> GaussianParams:
    return GaussianParams(p.loc[None], p.scale[None])


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

    def _setup(self, shape, seeds, device):
        """Split geometry, per-image split permutations (B, n) and the flat
        (B * num_blocks, 2) block keys of B latents of ``shape``."""
        plan = plan_split(int(np.prod(shape)), self.block_size)
        roots = rng.root_keys(seeds, device=device)               # (B, 2)
        perms = split_permutations(roots, plan)                    # (B, n)
        blocks = torch.arange(plan.num_blocks, dtype=torch.int64,
                              device=device)
        bkeys = rng.block_key(roots[:, None, :], blocks)           # (B, nb, 2)
        return plan, perms, bkeys.reshape(-1, 2)

    def required_partitions(self, target: GaussianParams,
                            coder: GaussianParams, seed: int = 0) -> int:
        """Host-side helper: max ceil(KL/Omega) over blocks, for choosing a
        large-enough static ``max_partitions``.  Always in [1, 2^24]: a
        non-finite or huge KL reports the cap, a zero KL reports 1."""
        plan, perms, _ = self._setup(target.loc.shape, [seed],
                                     target.loc.device)
        kls = block_kl(split_coders(_batch1(target), plan, perms),
                       split_coders(_batch1(coder), plan, perms))
        kls = np.nan_to_num(kls.double().cpu().numpy(), nan=np.inf,
                            posinf=np.inf, neginf=0.0)
        need = float(np.max(np.ceil(kls / self.kl_per_partition)))
        return int(max(1.0, min(need, 2.0 ** 24)))

    def encode(self, target: GaussianParams, coder: GaussianParams,
               seed: int) -> CodedLatent:
        """Encode one latent: ``encode_batch`` of one image."""
        out = self.encode_batch(_batch1(target), _batch1(coder), [seed])
        return CodedLatent(out.indices[0], out.counts[0], out.sample[0])

    def decode(self, coder: GaussianParams, indices: torch.Tensor,
               counts: torch.Tensor, seed: int) -> torch.Tensor:
        """Replay one latent: ``decode_batch`` of one image."""
        dev = coder.loc.device
        return self.decode_batch(
            _batch1(coder), torch.as_tensor(indices, device=dev)[None],
            torch.as_tensor(counts, device=dev)[None], [seed])[0]

    def _batch_ratios(self):
        ratios = self._ratios()
        if ratios is not None and np.ndim(ratios) > 1:
            raise NotImplementedError(
                "per-image aux-variance-ratio tables cannot share one "
                "block-codec call; broadcast the table instead")
        return ratios

    def encode_batch(self, targets: GaussianParams, coders: GaussianParams,
                     seeds) -> CodedLatent:
        """Encode B latents (leading axis of ``targets``/``coders``) with
        per-image ``seeds`` in one block-codec call.  Returns indices
        (B, num_blocks, P), counts (B, num_blocks) and samples (B, *shape),
        image i equal to ``encode(target_i, coder_i, seeds[i])``."""
        ratios = self._batch_ratios()
        B, shape = targets.loc.shape[0], targets.loc.shape[1:]
        dev = targets.loc.device
        with span("coder.split", card=dev) as sp:
            plan, perms, bkeys = self._setup(shape, seeds, dev)
            sp.count(blocks=B * plan.num_blocks)
            t_blocks = split_coders(targets, plan, perms)
            c_blocks = split_coders(coders, plan, perms)
        # The encoder embeds the decoder: the block codec reports the decode
        # replay of its indices as the sample, so it is not replayed again.
        coded = self._encode_blocks(t_blocks, c_blocks, bkeys, ratios)
        nb = plan.num_blocks
        with span("coder.split", card=dev, blocks=B * nb):
            sample = merge_batch(coded.sample, shape, plan, perms)
        return CodedLatent(coded.indices.reshape(B, nb, -1),
                           coded.count.reshape(B, nb), sample)

    def decode_batch(self, coders: GaussianParams, indices: torch.Tensor,
                     counts: torch.Tensor, seeds) -> torch.Tensor:
        """Replay B latents in one call: ``indices`` (B, num_blocks, P),
        ``counts`` (B, num_blocks); image i equals ``decode`` with
        ``seeds[i]``."""
        ratios = self._batch_ratios()
        B, shape = coders.loc.shape[0], coders.loc.shape[1:]
        dev = coders.loc.device
        with span("coder.split", card=dev) as sp:
            plan, perms, bkeys = self._setup(shape, seeds, dev)
            nb = B * plan.num_blocks
            sp.count(blocks=nb)
            c_blocks = split_coders(coders, plan, perms)
        indices = torch.as_tensor(indices, device=dev)
        samples = self._decode_blocks(
            c_blocks, indices.reshape(nb, indices.shape[-1]),
            torch.as_tensor(counts, device=dev).reshape(-1), bkeys, ratios)
        with span("coder.split", card=dev, blocks=nb):
            return merge_batch(samples, shape, plan, perms)

    def _block_nats(self, counts: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def codelength_nats(self, coded: CodedLatent) -> torch.Tensor:
        """The latent's code length in nats: the blocks' float32 code
        lengths summed in XLA-CPU's order (``utils.xla_sum_f32``), which is
        ``rec_tpu``'s float32 value bit for bit at any block count."""
        nats = self._block_nats(torch.as_tensor(coded.counts).reshape(-1))
        return xla_sum_f32(nats.cpu())


@dataclasses.dataclass(frozen=True)
class GaussianCoder(_BlockCoder):
    """KL-partitioned Gaussian coder with an importance sampler: 2^
    ``coding_bits`` proposals per partition, drawn ``candidate_chunk`` rows
    at a time."""

    kl_per_partition: float = 3.0
    coding_bits: int = 12
    block_size: Optional[int] = 1000
    max_partitions: int = 24
    candidate_chunk: int = 1024
    stream: str = "fmix"
    aux_variance_ratios: Optional[tuple] = None

    def _cfg(self):
        return importance.ImportanceCoderConfig(
            kl_per_partition=self.kl_per_partition,
            coding_bits=self.coding_bits,
            max_partitions=self.max_partitions,
            candidate_chunk=self.candidate_chunk, stream=self.stream)

    @property
    def max_index(self) -> int:
        """The index alphabet's size, which the ``.rec`` container needs."""
        return 1 << self.coding_bits

    def _encode_blocks(self, targets, coders, bkeys, ratios):
        return importance.encode_blocks(self._cfg(), targets, coders, bkeys,
                                        ratios)

    def _decode_blocks(self, coders, indices, counts, bkeys, ratios):
        return importance.decode_blocks(self._cfg(), coders, indices,
                                        counts, bkeys, ratios)

    def _block_nats(self, counts):
        return importance.codelength_nats(self._cfg(), counts)


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

    @property
    def max_index(self) -> int:
        """The index alphabet's size, which the ``.rec`` container needs."""
        return self.n_samples

    def _encode_blocks(self, targets, coders, bkeys, ratios):
        return beam_search.encode_blocks(self._cfg(), targets, coders, bkeys,
                                         ratios)

    def _decode_blocks(self, coders, indices, counts, bkeys, ratios):
        return beam_search.decode_blocks(self._cfg(), coders, indices,
                                         counts, bkeys, ratios)

    def _block_nats(self, counts):
        return self._cfg().codelength_nats(counts)


# Either coder family: the models and the CLIs take both.
Coder = Union[GaussianCoder, BeamSearchCoder]
