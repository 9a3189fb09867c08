"""The encoder's side of the beam-search coder, plain: the partition count
of each block from its KL, the beam search at the stated B, S and Omega
over the per-beam candidate streams, and the objective the search
maximises, so that the check can hold a file's indices to what a search
of those settings finds.

The search scores as the coder states it (candidate eps and the auxiliary
scale in bfloat16, their product in bfloat16, the sum with the bfloat16
beam in float32, the log density ratio in float32), but in its own order
of operations, so near ties may go the other way; the objective of the
result is taken in float64 from the replayed sample.
"""

from __future__ import annotations

import torch

from . import rng
from .beam import BeamConfig, Split, replay_blocks, split_blocks, split_setup
from .gauss import GaussianParams, auxiliary_target, log_density_ratio
from .partition import block_kl, merge_batch, num_partitions, schedule_table

# Candidate elements (blocks x B x S x D) one search step holds at most.
CHUNK_ELEMENTS = 1 << 26


def block_counts(cfg: BeamConfig, targets: GaussianParams,
                 coders: GaussianParams) -> torch.Tensor:
    """Partitions of each block, ceil(KL / Omega) within the budget."""
    return torch.clamp(num_partitions(block_kl(targets, coders),
                                      cfg.kl_per_partition),
                       max=cfg.max_partitions).to(torch.int64)


def objective(targets: GaussianParams, coders: GaussianParams,
              z: torch.Tensor) -> torch.Tensor:
    """Per block, sum over its dims of log q(z) - log p(z), in float64."""
    q = GaussianParams(targets.loc.double(), targets.scale.double())
    p = GaussianParams(coders.loc.double(), coders.scale.double())
    return torch.sum(log_density_ratio(z.double(), q, p), dim=-1)


def _search(cfg: BeamConfig, targets: GaussianParams,
            coders: GaussianParams, bkeys: torch.Tensor, n: torch.Tensor
            ) -> torch.Tensor:
    N, D = targets.loc.shape
    B, S, P = cfg.n_beams, cfg.n_samples, cfg.max_partitions
    dev = targets.loc.device
    bf16 = torch.bfloat16
    w, c_after = schedule_table(n, P, None, device=dev)
    beams = torch.zeros((N, B, D), dtype=torch.float32, device=dev)
    hashes = rng.fnv_init((N, B), device=dev)
    chosen = torch.zeros((N, B, P), dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)[:, None]
    for t in range(int(n.max()) if N else 0):
        aux_scale = torch.sqrt(w[:, t, None]) * coders.scale
        cum_scale = torch.sqrt(c_after[:, t, None]) * coders.scale
        aux = auxiliary_target(targets, coders, c_after[:, t, None]
                               * coders.var)
        keys = rng.beam_stream_key(rng.step_key(bkeys, t)[:, None, :],
                                   hashes)
        eps = rng.normal_stream(keys, (S, D), stream=cfg.stream)
        x = (beams.to(bf16).float()[:, :, None, :]
             + (aux_scale.to(bf16)[:, None, None, :]
                * eps.to(bf16)).float())
        num = GaussianParams(aux.loc[:, None, None], aux.scale[:, None, None])
        den = GaussianParams(torch.zeros_like(cum_scale)[:, None, None],
                             cum_scale[:, None, None])
        scores = torch.sum(log_density_ratio(x, num, den), dim=-1)
        if t == 0:
            scores[:, 1:] = -torch.inf
        top = torch.topk(scores.reshape(N, B * S), B, dim=-1).indices
        parent, cand = top // S, top % S
        new_beams = (beams[rows, parent]
                     + aux_scale[:, None, :] * eps[rows, parent, cand])
        new_chosen = chosen[rows, parent].clone()
        new_chosen[:, :, t] = cand
        new_hashes = rng.fnv_step(hashes[rows, parent], cand)
        live = (t < n)[:, None]
        beams = torch.where(live[:, :, None], new_beams, beams)
        hashes = torch.where(live, new_hashes, hashes)
        chosen = torch.where(live[:, :, None], new_chosen, chosen)
    return chosen[:, 0]


def search(cfg: BeamConfig, targets: GaussianParams, coders: GaussianParams,
           bkeys: torch.Tensor) -> tuple:
    """The best beam's indices (N, P) and the counts (N,) of N blocks."""
    N, D = targets.loc.shape
    n = block_counts(cfg, targets, coders)
    step = max(1, CHUNK_ELEMENTS // (cfg.n_beams * cfg.n_samples * D))
    parts = []
    for a in range(0, N, step):
        sl = slice(a, a + step)
        parts.append(_search(cfg, GaussianParams(targets.loc[sl],
                                                 targets.scale[sl]),
                             GaussianParams(coders.loc[sl], coders.scale[sl]),
                             bkeys[sl], n[sl]))
    indices = (torch.cat(parts) if parts else
               torch.zeros((0, cfg.max_partitions), dtype=torch.int64))
    return indices, n


def judge(cfg: BeamConfig, posteriors: GaussianParams,
          priors: GaussianParams, indices, counts, seeds) -> dict:
    """One latent of B images, (B, h, w, c) each, against its file's
    (indices (B, blocks, P), counts (B, blocks)): the sample the file
    replays to (B, h, w, c), and per block the objective of that sample,
    the objective of the reference search's best beam, and both counts."""
    B, shape = priors.loc.shape[0], priors.loc.shape[1:]
    dev = priors.loc.device
    sp: Split = split_setup(cfg, shape, seeds, dev)
    q, p = split_blocks(posteriors, sp), split_blocks(priors, sp)
    ind = torch.as_tensor(indices, device=dev)
    ind = ind.reshape(B * sp.plan.num_blocks, ind.shape[-1])
    cnt = torch.as_tensor(counts, device=dev).reshape(-1).to(torch.int64)
    z = replay_blocks(cfg, p, ind, cnt, sp.bkeys)
    ref_ind, ref_cnt = search(cfg, q, p, sp.bkeys)
    z_ref = replay_blocks(cfg, p, ref_ind, ref_cnt, sp.bkeys)
    return {"sample": merge_batch(z, shape, sp.plan, sp.perms),
            "file_objective": objective(q, p, z),
            "ref_objective": objective(q, p, z_ref),
            "file_counts": cnt, "ref_counts": ref_cnt}


class Tally:
    """The search numbers over every judged block: ``search_gap``, the
    mean of (reference search's objective - the file's) in nats a block,
    and ``count_gap``, the share of blocks whose coded partition count is
    not the one their KL gives."""

    def __init__(self):
        self.gap, self.miscounted, self.blocks = 0.0, 0, 0

    def add(self, judged: dict) -> None:
        self.gap += float(torch.sum(judged["ref_objective"]
                                    - judged["file_objective"]))
        self.miscounted += int(torch.sum(judged["ref_counts"]
                                         != judged["file_counts"]))
        self.blocks += int(judged["ref_counts"].numel())

    def numbers(self) -> dict:
        if not self.blocks:
            return {"search_gap": float("inf"), "count_gap": 1.0}
        return {"search_gap": self.gap / self.blocks,
                "count_gap": self.miscounted / self.blocks}
