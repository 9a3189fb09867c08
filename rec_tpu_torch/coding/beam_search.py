"""Beam-search relative entropy coding — the production coder (port of
rec_tpu/coding/beam_search.py).

Keep B beams of partial auxiliary-variable sums; per KL partition draw S
candidates per beam from a stream determined by the beam's index history,
score all B x S combined samples by log q_aux(x) - log p_cum_aux(x), keep
the top B.  The decoder replays only the winning beam's streams.

Two encode paths with one stream contract, as in ``rec_tpu``:

* the **scan path** below, a Python loop over partitions vectorised over
  blocks and beams — the CPU path, which reproduces ``rec_tpu``'s XLA scan
  path (bf16 scoring, beam-major ``top_k`` ties);
* on CUDA tensors, the hand-written beam-search kernel
  (``ops/mega_beam.py``), which chooses indices only.  Configs past its
  (S, 128) selection tile take the scan path on the card instead
  (``_use_fused``), as ``rec_tpu`` does on a TPU.

Either way the reported sample is the decode replay of the chosen indices
(``_replay_flat``: on CUDA tensors one launch of the replay kernel,
``ops/replay.py``), so ``encode().sample == decode(indices)`` bit for bit,
and the replay gives the same bits on the CPU and on the GPU.

``shared_pool=True`` changes the stream contract: every beam draws from ONE
pool of S candidate rows per partition (key ``pool_key(step_key)``, no
history hash), and the expanded quadratic score becomes a (B, D) @ (D, S)
product.  It always takes the scan path, as in ``rec_tpu``: the kernel
implements the per-beam streams only.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional

import torch

from . import rng
from .gauss import (GaussianParams, auxiliary_target, kl_divergence,
                    log_density_ratio, quadratic_coeffs)
from .partition import num_partitions, schedule_table
from .utils import tree_where, xla_sum_f32
from ..ops.threefry_normal import _log_f32, sqrt_f32
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    """Paper knobs: Omega=kl_per_partition, B=n_beams, (1+eps)=extra_samples
    (ref beam_search_coder.py:414-429)."""

    kl_per_partition: float = 3.0
    n_beams: int = 20
    extra_samples: float = 1.2
    max_partitions: int = 24
    # Candidate bit generator, part of the stream contract: "fmix" | "threefry".
    stream: str = "fmix"
    # One candidate pool of S rows per partition, shared by all beams (a
    # different stream contract; never the kernel).
    shared_pool: bool = False

    @property
    def n_samples(self) -> int:
        """Candidates per beam per partition: floor(e^(Omega * extra))."""
        return int(math.exp(self.kl_per_partition * self.extra_samples))

    def codelength_nats(self, count) -> torch.Tensor:
        """count * ln(n_samples) in float32, with ``rec_tpu``'s bits: the
        log is XLA-CPU's float32 log of the float32 S."""
        count = torch.as_tensor(count)
        log_s = _log_f32(torch.tensor([float(self.n_samples)],
                                      dtype=torch.float32))[0]
        return count.to(torch.float32) * log_s.to(count.device)


class BeamCodedBlock(NamedTuple):
    indices: torch.Tensor  # (N, max_partitions) int32
    count: torch.Tensor    # (N,) int32
    sample: torch.Tensor   # (N, D)


def _use_fused(cfg: BeamSearchConfig, on_cuda: bool) -> bool:
    """Whether an encode on CUDA tensors (``on_cuda``) launches the kernel:
    only for the per-beam streams (never ``shared_pool``, whose stream
    contract the kernel does not implement), with a known stream, and B and
    S within the kernel's selection tile.  Larger configs (Omega * (1 + eps)
    > ~4.85 gives S > 128) warn and take the scan path, which keeps the
    same streams, so their files are the same either way."""
    if (not on_cuda or cfg.shared_pool
            or cfg.stream not in ("fmix", "threefry")):
        return False
    from ..ops.mega_beam import _GRID_COLS as tile

    if cfg.n_beams > tile or cfg.n_samples > tile:
        warnings.warn(
            f"the beam-search kernel takes n_beams<={tile} and "
            f"n_samples<={tile} (got B={cfg.n_beams}, S={cfg.n_samples}); "
            f"encoding on the scan path", stacklevel=3)
        return False
    return True


def _counts(cfg: BeamSearchConfig, targets: GaussianParams,
            coders: GaussianParams) -> torch.Tensor:
    kls = torch.sum(kl_divergence(targets, coders), dim=-1)
    return torch.clamp(num_partitions(kls, cfg.kl_per_partition),
                       max=cfg.max_partitions)


def _top_k_beam_major(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index — ``lax.top_k``'s order."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _encode_blocks_scan(cfg: BeamSearchConfig, targets: GaussianParams,
                        coders: GaussianParams, bkeys: torch.Tensor,
                        ratios=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan path for N blocks (targets/coders (N, D), bkeys (N, 2)):
    ``rec_tpu.coding.beam_search.encode_blocks`` off-TPU, step for step.
    Returns the winning beam's indices (N, P) int32 and the counts (N,).

    Candidate scores follow the XLA program's rounding: the candidate eps
    and aux scale are rounded to bf16, their product is rounded to bf16,
    and the add with the bf16 beam runs in float32 unrounded (XLA-CPU
    drops the bf16 round trip of the sum; established by experiment)."""
    N, D = targets.loc.shape
    B, S, P = cfg.n_beams, cfg.n_samples, cfg.max_partitions
    dev = targets.loc.device
    n = _counts(cfg, targets, coders)
    n_max = int(n.max()) if N else 0
    w, c_after = schedule_table(n, P, ratios, device=dev)
    sqrt_w, sqrt_ca = sqrt_f32(w), sqrt_f32(c_after)
    p_var = coders.var

    beams = torch.zeros((N, B, D), dtype=torch.float32, device=dev)
    hashes = rng.fnv_init((N, B), device=dev)
    beam_indices = torch.zeros((N, B, P), dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)[:, None]
    for t in range(min(n_max, P)):
        aux_scale = sqrt_w[:, t, None] * coders.scale          # (N, D)
        cum_scale = sqrt_ca[:, t, None] * coders.scale
        aux_t = auxiliary_target(targets, coders, c_after[:, t, None] * p_var)
        cum_coder = GaussianParams(torch.zeros_like(cum_scale), cum_scale)

        skey = rng.step_key(bkeys, t)                            # (N, 2)
        if cfg.shared_pool:
            eps_pool = rng.normal_stream(rng.pool_key(skey), (S, D),
                                         stream=cfg.stream)      # (N, S, D)
            scores = _shared_pool_scores(beams, eps_pool, aux_t, cum_coder,
                                         aux_scale)
        else:
            beam_keys = rng.beam_stream_key(skey[:, None, :], hashes)
            eps = rng.normal_stream(beam_keys, (S, D), stream=cfg.stream)
            bf16 = torch.bfloat16
            prod = (aux_scale.to(bf16)[:, None, None, :]
                    * eps.to(bf16)).float()
            combined = beams.to(bf16).float()[:, :, None, :] + prod
            aux4 = GaussianParams(aux_t.loc[:, None, None, :],
                                  aux_t.scale[:, None, None, :])
            cum4 = GaussianParams(cum_coder.loc[:, None, None, :],
                                  cum_coder.scale[:, None, None, :])
            scores = torch.sum(log_density_ratio(combined, aux4, cum4),
                               dim=-1)                           # (N, B, S)
        if t == 0:
            # All beams share the empty history: only beam 0 is scored.
            scores[:, 1:, :] = -torch.inf
        flat = _top_k_beam_major(scores.reshape(N, B * S), B)   # (N, B)
        parent = flat // S
        cand = flat % S

        if cfg.shared_pool:
            winner_eps = eps_pool[rows, cand]                    # (N, B, D)
        else:
            winner_eps = rng.normal_stream_row(beam_keys[rows, parent],
                                               cand, S, D, stream=cfg.stream)
        new_beams = beams[rows, parent] + aux_scale[:, None, :] * winner_eps
        new_hashes = rng.fnv_step(hashes[rows, parent], cand)
        new_indices = beam_indices[rows, parent].clone()
        new_indices[:, :, t] = cand
        beams, hashes, beam_indices = tree_where(
            t < n, (new_beams, new_hashes, new_indices),
            (beams, hashes, beam_indices))
    return beam_indices[:, 0].to(torch.int32), n


def _shared_pool_scores(beams: torch.Tensor, eps_pool: torch.Tensor,
                        aux_t: GaussianParams, cum_coder: GaussianParams,
                        aux_scale: torch.Tensor) -> torch.Tensor:
    """(N, B, S) scores of every beam's parent (N, B, D) plus every pool row
    (N, S, D) without forming the (N, B, S, D) candidates: with
    x = beam + aux_scale * eps the quadratic score separates into

        const_b + sum_d c1_bd eps_sd + sum_d c2_d eps_sd^2,

    as ``rec_tpu`` evaluates it: c1, c2 and eps rounded to bf16, their
    products (exact in float32) accumulated in float32 with TF32 off.  The
    square is the float32 square of the bf16 eps (XLA-CPU keeps it in
    float32).  The order of the D-sums of XLA-CPU's dot is not reproduced,
    so near ties may flip."""
    qa, qb, qc_sum = quadratic_coeffs(aux_t, cum_coder)         # (N, D)
    bf16 = torch.bfloat16
    const_b = (xla_sum_f32((qa[:, None] * beams + qb[:, None]) * beams)
               + qc_sum[:, None])                                 # (N, B)
    c1 = ((2.0 * qa[:, None] * beams + qb[:, None])
          * aux_scale[:, None]).to(bf16).float()                  # (N, B, D)
    c2 = (qa * torch.square(aux_scale)).to(bf16).float()          # (N, D)
    eps_lp = eps_pool.to(bf16).float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cross = torch.matmul(c1, eps_lp.transpose(1, 2))          # (N, B, S)
        e2 = torch.matmul(torch.square(eps_lp), c2[:, :, None])[..., 0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return const_b[:, :, None] + cross + e2[:, None, :]


def encode_blocks(cfg: BeamSearchConfig, targets: GaussianParams,
                  coders: GaussianParams, bkeys: torch.Tensor,
                  ratios=None) -> BeamCodedBlock:
    """Beam-search encode of N latent blocks.

    CUDA tensors go through the hand-written kernel (ops/mega_beam.py)
    where ``_use_fused`` allows it; CPU tensors and the rest take the scan
    path, as ``rec_tpu`` does off-TPU.  Either way the reported sample is
    the decode replay of the chosen indices, so callers need not replay
    again."""
    if _use_fused(cfg, targets.loc.is_cuda):
        from ..ops.mega_beam import mega_encode_blocks

        indices, n = mega_encode_blocks(
            targets, coders, bkeys, kl_per_partition=cfg.kl_per_partition,
            n_beams=cfg.n_beams, n_samples=cfg.n_samples,
            max_partitions=cfg.max_partitions, stream=cfg.stream,
            ratios=ratios)
    else:
        indices, n = _encode_blocks_scan(cfg, targets, coders, bkeys, ratios)
    sample = _replay_flat(cfg, coders, indices, n, bkeys, ratios)
    return BeamCodedBlock(indices=indices, count=n, sample=sample)


def _replay_flat(cfg: BeamSearchConfig, coders: GaussianParams,
                 indices: torch.Tensor, counts, bkeys: torch.Tensor,
                 ratios=None) -> torch.Tensor:
    """Flat replay of N blocks: the winning streams' rows summed with the
    schedule's weights (``ops/replay.py``: one kernel launch on CUDA
    tensors, the eager chain of ``partition.replay_contract`` on CPU ones;
    ``rec_tpu``'s bits for any prior, the same bits on the CPU and on the
    GPU).  Its span counts the N * P rows it draws and sums and the live
    ones, sum(min(count, P)) (held on the device)."""
    from ..ops.replay import replay_blocks

    N = coders.loc.shape[0]
    P = cfg.max_partitions
    dev = coders.loc.device
    with span("coder.replay", card=dev, rows=N * P) as sp:
        counts = torch.clamp(
            torch.as_tensor(counts, device=dev).to(torch.int64), max=P)
        sp.count(live_rows=counts)
        with span("replay.schedule"):
            w, _ = schedule_table(counts, P, ratios, device=dev)
        return replay_blocks(coders, w, indices, counts, bkeys,
                             stream=cfg.stream, shared_pool=cfg.shared_pool)


def decode_block(cfg: BeamSearchConfig, coder: GaussianParams,
                 indices: torch.Tensor, count, block_key: torch.Tensor,
                 ratios=None) -> torch.Tensor:
    """Replay one block: the batched replay at N=1."""
    coders = GaussianParams(coder.loc[None], coder.scale[None])
    cnt = torch.as_tensor(count, device=coder.loc.device).reshape(1)
    return _replay_flat(cfg, coders, indices[None], cnt, block_key[None],
                        ratios)[0]


def decode_blocks(cfg: BeamSearchConfig, coders: GaussianParams,
                  indices: torch.Tensor, counts, bkeys: torch.Tensor,
                  ratios=None) -> torch.Tensor:
    """Batched replay of N blocks; bit-identical per block to
    ``decode_block``."""
    return _replay_flat(cfg, coders, indices, counts, bkeys, ratios)


def encode_block(cfg: BeamSearchConfig, target: GaussianParams,
                 coder: GaussianParams, block_key: torch.Tensor,
                 ratios=None) -> BeamCodedBlock:
    """Encode one block (D,): the batched encode at N=1."""
    out = encode_blocks(cfg, GaussianParams(target.loc[None],
                                            target.scale[None]),
                        GaussianParams(coder.loc[None], coder.scale[None]),
                        block_key[None], ratios)
    return BeamCodedBlock(out.indices[0], out.count[0], out.sample[0])
