"""Importance-sampling relative entropy coding, Gaussian (port of
rec_tpu/coding/importance.py).

Each KL partition draws 2^coding_bits standard-normal proposals in chunks of
``candidate_chunk`` rows; chunk c of step t of a block is the stream
``fold_in(step_key(block_key, t), c)`` with proposal r = counter rows
[r*D, (r+1)*D).  The encoder keeps the proposal of largest importance weight
(a running argmax over chunks: the first maximum within a chunk, a later
chunk only if strictly larger, a chunk holding a NaN weight never); the
decoder regenerates only the transmitted row.

Encode.  The partition loop runs on the host over the live blocks only
(blocks past their count keep their carry, as ``rec_tpu``'s masked scan
does), vectorised over (block, chunk) pairs in groups of at most
``GROUP_ELEMENTS`` proposal elements, which bounds the memory on the card
and keeps the CPU's work in cache.
A proposal's weight is the sum over D of the per-dimension quadratic
``log_density_ratio`` (``rec_tpu/coding/gauss.py:113-130``), added in
XLA-CPU's order (``utils.xla_sum_f32``): the proposals are generated
straight into that order's window-major layout.  The normals come from
``rng.normal_table`` (the replay's map) and the fmix bits from
``rng.fmix_bits_i32``; every float step is a basic IEEE operation, so the
encode picks the same indices on the CPU and on the GPU.  Against
``rec_tpu``, whose fused XLA program rounds the per-dimension terms
differently in the last bits, indices agree except at near ties.

Decode.  The sample is the replay of the transmitted indices through
``partition.replay_contract`` — ``rec_tpu``'s ``einsum("np,npd->nd")`` over
the partition axis is, on XLA-CPU, the same sequential fused multiply-add
chain as beam search's pinned scan — so it is ``rec_tpu``'s float32 bits
in both directions, and ``encode().sample == decode(indices)``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .gauss import (GaussianParams, auxiliary_target, conditional_coder,
                    conditional_target, kl_divergence)
from .partition import (aux_variance_ratio, num_partitions, replay_contract,
                        schedule_table)
from .utils import (SUM_WINDOW, CodingError, sum_in_order, sum_pads,
                    xla_sum_f32)
from ..ops.threefry_normal import _log_f32, sqrt_f32

# Proposal elements (proposals x padded dims) generated at once, by device
# type: whole (block, chunk) pairs, or rows of one pair when a pair is
# larger.  On the card, 2^25 keeps the int32 bits, the normals and the
# score temporaries around a gigabyte; on the CPU, 2^18 keeps a group's
# temporaries in cache, where the elementwise chain runs several times
# faster than from memory.
GROUP_ELEMENTS = {"cuda": 1 << 25, "cpu": 1 << 18}
GUMBEL_TAG = 0x6b1  # encoder-only Gumbel stream of a step key


@dataclasses.dataclass(frozen=True)
class ImportanceCoderConfig:
    """GaussianCoder + importance-sampler knobs: ``coding_bits`` bits per
    partition (2^bits proposals), ``max_partitions`` the static budget."""

    kl_per_partition: float = 3.0
    coding_bits: int = 12
    max_partitions: int = 24
    candidate_chunk: int = 1024
    # Proposal bit generator, part of the stream contract: "fmix" |
    # "threefry".
    stream: str = "fmix"

    @property
    def num_candidates(self) -> int:
        return 1 << self.coding_bits

    @property
    def chunk_size(self) -> int:
        return min(self.candidate_chunk, self.num_candidates)

    @property
    def num_chunks(self) -> int:
        return -(-self.num_candidates // self.chunk_size)


class CodedBlock(NamedTuple):
    indices: torch.Tensor  # (N, max_partitions) int32, valid for t < count
    count: torch.Tensor    # (N,) int32
    sample: torch.Tensor   # (N, D) the decode replay of the indices


class _Layout:
    """The window-major order in which XLA-CPU adds a D-dim row: position
    (i, w) of a (win, nwin) array holds padded dimension w * win + i, so the
    in-order window sums are ``sum_in_order`` over axis -2 and their sum is
    ``xla_sum_f32`` over axis -1.  Rows of up to 32 dims are one window.
    ``src`` gives each position's dimension (clamped), ``valid`` marks the
    zero padding."""

    def __init__(self, D: int, device):
        if D <= SUM_WINDOW:
            lo, win, n_pad = 0, D, D
        else:
            lo, hi = sum_pads(D)
            win, n_pad = SUM_WINDOW, D + lo + hi
        pos = torch.arange(n_pad, device=device).reshape(-1, win).T
        d = pos - lo
        self.valid = (d >= 0) & (d < D)
        self.src = d.clamp(0, D - 1)
        self.size = n_pad

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., win, nwin), zero at the padding."""
        return torch.where(self.valid, x[..., self.src], 0.0)


@functools.lru_cache(maxsize=16)
def _geometry(C: int, D: int, device: torch.device, stream: str):
    """The layout of a D-dim row and the (C, win, nwin) counters of one
    chunk's proposals in it (fmix: pre-multiplied by the golden ratio)."""
    layout = _Layout(D, device)
    rows = torch.arange(C, dtype=torch.int64, device=device)
    ctr = rows[:, None, None] * D + layout.src
    if stream == "fmix":
        ctr = rng.fmix_golden_i32(ctr)
    elif stream != "threefry":
        raise ValueError(f"unknown stream {stream!r}")
    return layout, ctr


def _regen_candidate(cfg: ImportanceCoderConfig, skeys: torch.Tensor,
                     index: torch.Tensor, dim: int) -> torch.Tensor:
    """Proposal ``index`` of the step keys ``skeys`` (..., 2): row
    ``index % C`` of chunk ``fold_in(skey, index // C)``, (..., dim) — what
    the decoder regenerates from a transmitted index."""
    C = cfg.chunk_size
    index = torch.as_tensor(index, dtype=torch.int64, device=skeys.device)
    return rng.normal_stream_row(rng.fold_in(skeys, index // C), index % C,
                                 C, dim, stream=cfg.stream)


def _chunk_keys(skeys: torch.Tensor, K: int) -> torch.Tensor:
    """The K chunk keys fold_in(step key, c) of step keys (N, 2): (N, K, 2),
    derived once per step (each fold_in is a threefry evaluation)."""
    return rng.fold_in(skeys[:, None, :],
                       torch.arange(K, device=skeys.device))


def _proposals(keys: torch.Tensor, ctr: torch.Tensor, stream: str
               ) -> torch.Tensor:
    """Standard normals of the chunk keys (G, 2) at the laid-out counters:
    (G, C, win, nwin)."""
    if stream == "fmix":
        k = rng.as_i32(keys)[:, :, None, None, None]
        bits = rng.fmix_bits_i32(k[:, 0], k[:, 1], ctr)
    else:
        bits = rng.stream_bits(keys, ctr, "threefry")
    return rng._bits_to_normal_f32(bits)


def _ratio_coeffs(std_t: GaussianParams):
    """(a, b, c) of log N(x; std_t) - log N(x; 0, 1) = (a x + b) x + c, as
    XLA-CPU folds ``gauss.log_density_ratio`` against the standard normal
    (its float32 log included)."""
    inv = 1.0 / torch.square(std_t.scale)
    a = (inv - 1.0) * -0.5
    b = std_t.loc * inv
    c = torch.square(std_t.loc) * inv * -0.5 - _log_f32(std_t.scale)
    return a, b, c


def _chunk_weights(cfg: ImportanceCoderConfig, skeys: torch.Tensor,
                   std_t: GaussianParams, alpha: float,
                   log_weighting_fn) -> torch.Tensor:
    """Log importance weights (N, num_chunks, C) of every proposal of N
    blocks' steps, chunk by chunk as ``rec_tpu`` forms them (finite
    ``alpha``: ``alpha * log w`` plus the encoder-only Gumbel noise)."""
    N, D = std_t.loc.shape
    C, K = cfg.chunk_size, cfg.num_chunks
    dev = std_t.loc.device
    out = torch.empty((N, K, C), dtype=torch.float32, device=dev)
    if log_weighting_fn is not None:
        keys = _chunk_keys(skeys, K)
        for c in range(K):
            eps = rng.normal_stream(keys[:, c], (C, D), stream=cfg.stream)
            out[:, c] = log_weighting_fn(eps)
    else:
        layout, ctr = _geometry(C, D, dev, cfg.stream)
        coeffs = [layout.gather(v)[:, None] for v in _ratio_coeffs(std_t)]
        rows = max(1, GROUP_ELEMENTS[dev.type] // layout.size)
        pairs, rows = max(1, rows // C), min(rows, C)
        keys = _chunk_keys(skeys, K).reshape(N * K, 2)
        block = torch.arange(N, device=dev).repeat_interleave(K)
        flat = out.view(N * K, C)
        for g in range(0, N * K, pairs):
            a, b, cc = (v[block[g:g + pairs]] for v in coeffs)
            for r in range(0, C, rows):
                x = _proposals(keys[g:g + pairs], ctr[r:r + rows],
                               cfg.stream)
                q = (a * x + b) * x + cc
                flat[g:g + pairs, r:r + rows] = xla_sum_f32(
                    sum_in_order(q, -2))
    if alpha != math.inf:
        gkeys = _chunk_keys(rng.fold_in(skeys, GUMBEL_TAG), K)
        out = alpha * out + rng.gumbel(gkeys, C)
    return out


def _argmax_candidates(cfg: ImportanceCoderConfig, skeys: torch.Tensor,
                       std_t: GaussianParams, alpha: float = math.inf,
                       log_weighting_fn=None):
    """Running argmax of importance weights over the chunked proposal
    streams of N blocks' steps (step keys (N, 2), standardized targets
    (N, D)).  Returns the global indices (N,) int32 and the winning
    proposals (N, D) — zeros where no weight beat -inf, as ``rec_tpu``'s
    carry starts."""
    N, D = std_t.loc.shape
    C = cfg.chunk_size
    logw = _chunk_weights(cfg, skeys, std_t, alpha, log_weighting_fn)
    best = torch.amax(logw, dim=-1)                   # NaN-propagating
    j = torch.argmax(logw, dim=-1)                    # first maximum
    # Sequentially a chunk wins only if strictly larger, and a NaN chunk
    # never: the first chunk holding the largest non-NaN maximum, if > -inf.
    best = torch.where(torch.isnan(best), -torch.inf, best)
    c = torch.argmax(best, dim=-1)
    found = torch.amax(best, dim=-1) > -torch.inf
    idx = torch.where(found, c * C + j.gather(1, c[:, None])[:, 0], 0)
    eps = torch.where(found[:, None], _regen_candidate(cfg, skeys, idx, D),
                      0.0)
    return idx.to(torch.int32), eps


def encode_gaussian_importance_sample(target: GaussianParams,
                                      coder: GaussianParams,
                                      key: torch.Tensor, coding_bits: int,
                                      candidate_chunk: int = 1024,
                                      alpha: float = math.inf,
                                      log_weighting_fn=None):
    """Single-shot importance coding of a (D,) target against a coder under
    ``key`` (2,).  Returns (index, sample).

    ``alpha`` in [1, inf]: inf takes the largest importance weight; finite
    alpha adds Gumbel noise to ``alpha * log w`` (encoder-only: decode is
    unchanged).  ``log_weighting_fn`` scores (..., C, D) standardized
    proposals instead, for non-Gaussian targets."""
    if alpha < 1.0:
        raise CodingError(f"alpha must be in [1, inf), got {alpha}")
    cfg = ImportanceCoderConfig(coding_bits=coding_bits,
                                candidate_chunk=candidate_chunk)
    std_t = GaussianParams(((target.loc - coder.loc) / coder.scale)[None],
                           (target.scale / coder.scale)[None])
    idx, eps = _argmax_candidates(cfg, key[None], std_t, alpha=alpha,
                                  log_weighting_fn=log_weighting_fn)
    return idx[0], coder.loc + coder.scale * eps[0]


def decode_gaussian_importance_sample(coder: GaussianParams, index,
                                      key: torch.Tensor, coding_bits: int,
                                      candidate_chunk: int = 1024
                                      ) -> torch.Tensor:
    cfg = ImportanceCoderConfig(coding_bits=coding_bits,
                                candidate_chunk=candidate_chunk)
    eps = _regen_candidate(cfg, key, index, coder.loc.shape[-1])
    return coder.loc + coder.scale * eps


def _counts(cfg: ImportanceCoderConfig, targets: GaussianParams,
            coders: GaussianParams) -> torch.Tensor:
    kls = torch.sum(kl_divergence(targets, coders), dim=-1)
    return torch.clamp(num_partitions(kls, cfg.kl_per_partition),
                       max=cfg.max_partitions)


def step_ratios(counts: np.ndarray, t: int, ratios=None) -> np.ndarray:
    """float32 variance ratios of step t for blocks of ``counts`` > t: the
    auxiliary variable of index count - 1 - t."""
    return np.asarray(aux_variance_ratio(counts - 1 - t, ratios), np.float32)


def _aux_step(tg: GaussianParams, cd: GaussianParams, ratio: torch.Tensor):
    """Step quantities of blocks (tg, cd (R, D)) at variance ratios (R,):
    the auxiliary variance, its scale, and the auxiliary target
    standardized against the zero-mean auxiliary coder."""
    aux_var = ratio[:, None] * cd.var
    aux_t = auxiliary_target(tg, cd, aux_var)
    aux_scale = sqrt_f32(aux_var)
    std_t = GaussianParams(aux_t.loc / aux_scale, aux_t.scale / aux_scale)
    return aux_var, aux_scale, std_t


def _condition(tg: GaussianParams, cd: GaussianParams,
               aux_var: torch.Tensor, aux_sample: torch.Tensor):
    """(target, coder) conditioned on the chosen auxiliary sample."""
    return (conditional_target(tg, cd, aux_var, aux_sample),
            conditional_coder(cd, aux_var, aux_sample))


def encode_blocks(cfg: ImportanceCoderConfig, targets: GaussianParams,
                  coders: GaussianParams, bkeys: torch.Tensor,
                  ratios=None) -> CodedBlock:
    """Encode N blocks (targets/coders (N, D), block keys (N, 2)): at step t
    every block with count > t draws its auxiliary variable's proposals and
    conditions its (target, coder) pair on the winner; the loop stops at
    the largest count.  The reported sample is the decode replay."""
    N, D = targets.loc.shape
    P = cfg.max_partitions
    dev = targets.loc.device
    n = _counts(cfg, targets, coders)
    n_host = n.cpu().numpy()
    tgt = GaussianParams(targets.loc.clone(), targets.scale.clone())
    cod = GaussianParams(coders.loc.clone(), coders.scale.clone())
    indices = torch.zeros((N, P), dtype=torch.int32, device=dev)
    for t in range(min(int(n_host.max(initial=0)), P)):
        live = np.nonzero(n_host > t)[0]
        rows = torch.as_tensor(live, device=dev)
        ratio = torch.from_numpy(step_ratios(n_host[live], t, ratios)).to(dev)
        tg = GaussianParams(tgt.loc[rows], tgt.scale[rows])
        cd = GaussianParams(cod.loc[rows], cod.scale[rows])
        aux_var, aux_scale, std_t = _aux_step(tg, cd, ratio)
        idx, eps = _argmax_candidates(cfg, rng.step_key(bkeys[rows], t),
                                      std_t)
        new_t, new_c = _condition(tg, cd, aux_var, aux_scale * eps)
        for old, new in zip(tgt + cod, new_t + new_c):
            old[rows] = new
        indices[rows, t] = idx
    sample = _replay_flat(cfg, coders, indices, n, bkeys, ratios)
    return CodedBlock(indices=indices, count=n, sample=sample)


def _replay_flat(cfg: ImportanceCoderConfig, coders: GaussianParams,
                 indices: torch.Tensor, counts, bkeys: torch.Tensor,
                 ratios=None) -> torch.Tensor:
    """Replay N blocks: step t's row is proposal ``idx % C`` of the chunk
    key ``fold_in(step_key(block_key, t), idx // C)``; the rows go through
    ``partition.replay_contract`` with the closed-form schedule."""
    N, D = coders.loc.shape
    P = cfg.max_partitions
    dev = coders.loc.device
    counts = torch.clamp(torch.as_tensor(counts, device=dev).to(torch.int64),
                         max=P)
    steps = torch.arange(P, dtype=torch.int64, device=dev)
    skeys = rng.step_key(bkeys[:, None, :], steps[None, :])     # (N, P, 2)
    eps = _regen_candidate(cfg, skeys, torch.as_tensor(indices, device=dev),
                           D)                                    # (N, P, D)
    w, _ = schedule_table(counts, P, ratios, device=dev)
    return replay_contract(coders, w, eps)


def decode_blocks(cfg: ImportanceCoderConfig, coders: GaussianParams,
                  indices: torch.Tensor, counts, bkeys: torch.Tensor,
                  ratios=None) -> torch.Tensor:
    """Batched replay; bit-identical per block to ``decode_block``."""
    return _replay_flat(cfg, coders, indices, counts, bkeys, ratios)


def encode_block(cfg: ImportanceCoderConfig, target: GaussianParams,
                 coder: GaussianParams, block_key: torch.Tensor,
                 ratios=None) -> CodedBlock:
    """Encode one block (D,): the batched encode at N=1."""
    out = encode_blocks(cfg, GaussianParams(target.loc[None],
                                            target.scale[None]),
                        GaussianParams(coder.loc[None], coder.scale[None]),
                        block_key[None], ratios)
    return CodedBlock(out.indices[0], out.count[0], out.sample[0])


def decode_block(cfg: ImportanceCoderConfig, coder: GaussianParams,
                 indices: torch.Tensor, count, block_key: torch.Tensor,
                 ratios=None) -> torch.Tensor:
    """Replay one block: the batched replay at N=1."""
    coders = GaussianParams(coder.loc[None], coder.scale[None])
    cnt = torch.as_tensor(count, device=coder.loc.device).reshape(1)
    return _replay_flat(cfg, coders, torch.as_tensor(indices)[None], cnt,
                        block_key[None], ratios)[0]


def codelength_nats(cfg: ImportanceCoderConfig, count) -> torch.Tensor:
    """count * coding_bits * ln 2 in float32, with ``rec_tpu``'s bits (the
    log is XLA-CPU's float32 log of 2)."""
    count = torch.as_tensor(count)
    ln2 = _log_f32(torch.tensor([2.0]))[0].to(count.device)
    return (count * cfg.coding_bits).to(torch.float32) * ln2
