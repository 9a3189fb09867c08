"""The beam-search coder's decode side, frozen from rec_tpu_torch's
``coding/beam_search.py`` and ``coding/coder.py`` for the benchmark's
reference: the split of a latent into blocks and the replay of a block's
(indices, counts) into its sample, which has to give the encoder's bits
(``search.judge`` replays a file's latents).  Only the per-beam streams
(fmix or threefry bits) are here; the shared pool and the importance
coder are on no benchmarked path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .gauss import GaussianParams
from .partition import (plan_split, replay_contract, schedule_table,
                        split_coders, split_permutations)


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Omega = kl_per_partition, B = n_beams, S = floor(e^(Omega * extra))."""

    kl_per_partition: float = 3.0
    n_beams: int = 20
    extra_samples: float = 1.2
    block_size: int = 1000
    max_partitions: int = 24
    stream: str = "fmix"

    @property
    def n_samples(self) -> int:
        return int(math.exp(self.kl_per_partition * self.extra_samples))


class Split(NamedTuple):
    plan: object
    perms: torch.Tensor
    bkeys: torch.Tensor


def split_setup(cfg: BeamConfig, shape, seeds, device) -> Split:
    """Split geometry, per-image permutations and the flat block keys of B
    latents of ``shape`` (HWC), each image keyed by its seed."""
    plan = plan_split(int(np.prod(shape)), cfg.block_size)
    roots = rng.root_keys(seeds, device=device)
    perms = split_permutations(roots, plan)
    blocks = torch.arange(plan.num_blocks, dtype=torch.int64, device=device)
    bkeys = rng.block_key(roots[:, None, :], blocks)
    return Split(plan, perms, bkeys.reshape(-1, 2))


def split_blocks(p: GaussianParams, sp: Split) -> GaussianParams:
    """(B, *shape) distributions -> (B * num_blocks, block_size)."""
    return split_coders(p, sp.plan, sp.perms)


def _replay_keys(cfg: BeamConfig, bkeys, indices, counts):
    N = bkeys.shape[0]
    P = cfg.max_partitions
    dev = bkeys.device
    steps = torch.arange(P, dtype=torch.int64, device=dev)
    skeys = rng.step_key(bkeys[:, None, :], steps[None, :])
    idx = indices.to(torch.int64)
    h = rng.fnv_init((N,), device=dev)
    hs = []
    for t in range(P):
        hs.append(h)
        h = torch.where(t < counts, rng.fnv_step(h, idx[:, t]), h)
    return rng.beam_stream_key(skeys, torch.stack(hs, dim=1))


def replay_blocks(cfg: BeamConfig, coders: GaussianParams, indices,
                  counts, bkeys) -> torch.Tensor:
    """The sample of N blocks from their indices (N, P) and counts (N,)."""
    N, D = coders.loc.shape
    P = cfg.max_partitions
    dev = coders.loc.device
    counts = torch.clamp(torch.as_tensor(counts, device=dev).to(torch.int64),
                         max=P)
    indices = torch.as_tensor(indices, device=dev)
    keys = _replay_keys(cfg, bkeys, indices, counts)
    w, _ = schedule_table(counts, P, None, device=dev)
    eps = rng.normal_stream_row(keys, indices.to(torch.int64), cfg.n_samples,
                                D, stream=cfg.stream)
    return replay_contract(coders, w, eps)
