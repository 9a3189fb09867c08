"""Harsha-style rejection-sampling REC (port of rec_tpu/coding/rejection.py).

Split across the host/device boundary as ``rec_tpu`` splits it:

  * mass estimation (the sorted empirical log-ratios of oversampled target
    draws) on the device;
  * the r/p* acceptance-buffer recursion in float64 host numpy, with the
    geometric-interval fast path;
  * the acceptance rounds over fixed-size proposal buffers, then a bounded
    spillover, as a host loop that reads the device once per round.

Proposals are standard-normal streams (the caller standardizes the aux
pair), so decode is index arithmetic on the shared stream: sample =
stream(fold_in(key, index // buffer))[index % buffer].

Bits.  ``rec_tpu`` jits the mass estimate and compiles each round's body
as one fused XLA program, in which XLA folds jax.random.normal's sqrt(2)
into a later multiply and LLVM contracts multiply-adds into fused ones.
The port copies those op sequences, read off XLA-CPU's optimized HLO and
object code (``_mass_ratio_terms``, ``_round_ratios``): the normals come
from the normal map's tables (``rng.erfinv_table`` before the sqrt(2),
``rng.normal_table`` after it), every fused multiply-add is
``fma_f32_exact``, the row sums add in XLA-CPU's order
(``_row_sum``), and exp and log are XLA-CPU's float32 ones
(``exp_f32``, ``_log_f32``).  Each step is a basic IEEE operation, so the
estimate, the buffers, the accepted index and the sample are the same bits
on the CPU, on the GPU and in ``rec_tpu`` on JAX-CPU (subnormal
intermediates aside: XLA-CPU flushes them to zero).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import rng
from .gauss import GaussianParams, kl_divergence
from .utils import SUM_WINDOW, CodingError, xla_sum_f32
from ..ops.threefry_normal import (_SQRT2_F32, _log_f32, exp_f32,
                                   fma_f32_exact)

# -0.5 * sqrt(2) in float32: XLA folds the ratio's -0.5 into the normal's
# sqrt(2) inside a round's program.
_HALF_SQRT2_NEG = float(np.float32(-0.5) * np.float32(_SQRT2_F32))
# Proposal elements (rows x D) generated at once, by device type (rows
# are independent, so the bits do not depend on it): on the card a whole
# 10^4 x 1000 draw in one chunk (~1 GB of int64 bits and float64 fma
# temporaries, a third of the launches of 2^22-element chunks); on the
# CPU 2^18, which keeps a chunk's temporaries in cache.
CHUNK_ELEMENTS = {"cuda": 1 << 24, "cpu": 1 << 18}
UNIFORM_TAG = 0x0acc


@dataclasses.dataclass(frozen=True)
class RejectionSamplerConfig:
    sample_buffer_size: int = 10000
    r_buffer_size: int = 10000
    mass_samples: int = 100
    oversampling: int = 100
    max_spillover_rounds: int = 1000
    max_kl: float = 20.0  # refuse at or above this


def _fma(a, b, c) -> torch.Tensor:
    a, b, c = torch.broadcast_tensors(a, b, c)
    return fma_f32_exact(a, b, c)


def _tables(key: torch.Tensor, rows: torch.Tensor, D: int):
    """The stream of ``key`` (on the rows' device) at rows ``rows`` (R,) of
    D: its erfinv factors and its normals (each (R, D)), from the normal
    map's tables."""
    dev = rows.device
    ctr = rows[:, None] * D + torch.arange(D, dtype=torch.int64, device=dev)
    idx = rng.table_index(rng.stream_bits(key, ctr, "threefry"))
    return rng.erfinv_table(dev)[idx], rng.normal_table(dev)[idx]


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sums over the last axis in the order XLA-CPU adds a row of
    a fused ratio: past SUM_WINDOW dims its reduce-window order
    (``xla_sum_f32``); up to it, the row reduce is emitted inside the
    ratio's loop with 8 vector lanes, lane j adding dims j, j+8, ... from
    0, the lanes added as a tree (4, 2, 1), then the 1-3 dims past the
    last whole vector in order (read off the object code at D = 16; it
    holds at D = 8, 16, 17, 19, 24 and 32 but not at D = 11, whose order
    is not reproduced)."""
    D = x.shape[-1]
    if D > SUM_WINDOW:
        return xla_sum_f32(x)
    whole = D - D % 8
    lanes = torch.zeros(x.shape[:-1] + (8,), dtype=x.dtype, device=x.device)
    for i in range(0, whole, 8):
        lanes = lanes + x[..., i:i + 8]
    while lanes.shape[-1] > 1:
        h = lanes.shape[-1] // 2
        lanes = lanes[..., :h] + lanes[..., h:]
    acc = lanes[..., 0]
    for i in range(whole, D):
        acc = acc + x[..., i]
    return acc


def _row_chunks(total: int, D: int, device: torch.device):
    step = max(1, CHUNK_ELEMENTS[device.type] // max(D, 1))
    return [(r, min(r + step, total)) for r in range(0, total, step)]


# ---------------------------------------------------------------------------
# Mass estimation (device)
# ---------------------------------------------------------------------------

def _mass_ratio_terms(target: GaussianParams, coder: GaussianParams):
    """Per-dimension terms of ``log N(y; coder) - log N(y; target)`` at
    y = target.loc + target.scale * sqrt(2) e, as XLA-CPU's fused
    ``estimate_mass`` forms them: (target.scale * sqrt(2), target.loc,
    -a, b, c) with b and c's differences single fused multiply-adds."""
    tl, ts = target.loc, target.scale
    cl, cs = coder.loc, coder.scale
    inv_n = 1.0 / (cs * cs)
    inv_d = 1.0 / (ts * ts)
    neg_a = (inv_n - inv_d) * 0.5
    b = fma_f32_exact(inv_n, cl, -(inv_d * tl))
    q = fma_f32_exact(inv_n, cl * cl, -(inv_d * (tl * tl)))
    c = q * -0.5 - _log_f32(cs / ts)
    return ts * _SQRT2_F32, tl, neg_a, b, c


def estimate_mass(target: GaussianParams, coder: GaussianParams,
                  key: torch.Tensor, n_samples: int = 100,
                  oversampling: int = 100):
    """Empirical discretization of the density ratio: draw n*o target
    samples (``jax.random.normal(key, (n*o, D))``), sort their log t/p
    ratios (stably), keep the o/2-strided midpoints.  Returns
    (log_ratios, t_mass, p_mass), each (n,) float32 on the target's
    device."""
    total = n_samples * oversampling
    D = target.loc.shape[-1]
    dev = target.loc.device
    key = key.to(dev)
    scale2, loc, neg_a, b, c = _mass_ratio_terms(target, coder)
    sums = torch.empty(total, dtype=torch.float32, device=dev)
    for r0, r1 in _row_chunks(total, D, dev):
        e, _ = _tables(key, torch.arange(r0, r1, device=dev), D)
        y = _fma(scale2, e, loc)
        sums[r0:r1] = _row_sum(_fma(y, _fma(-y, neg_a, b), c))
    t = float(np.float32(-np.log(np.float32(n_samples))))
    t_mass = torch.full((total,), t, dtype=torch.float32, device=dev)
    p_mass = t_mass + sums
    log_ratios = t_mass - p_mass
    order = torch.sort(log_ratios, stable=True).indices
    keep = order[oversampling // 2::oversampling]
    return log_ratios[keep], t_mass[keep], p_mass[keep]


# ---------------------------------------------------------------------------
# r / p* buffers (host, float64; rec_tpu's numpy, copied)
# ---------------------------------------------------------------------------

def r_pstar_naive(log_ratios, t_mass, p_mass, r_buffer_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The defining recursion, one buffer entry at a time (slow; the
    differential-test baseline):
        r_i    = r_{i-1} + (1 - p*_{i-1})
        p*_i   = (1 - P(ratio < r_i)) * r_i + T(ratio < r_i)
    """
    ratios = np.exp(np.asarray(log_ratios, np.float64))
    t_cum = np.exp(np.logaddexp.accumulate(np.asarray(t_mass, np.float64)))
    p_cum_arr = np.exp(np.logaddexp.accumulate(np.asarray(p_mass, np.float64)))
    p_zero = 1.0 - np.exp(_logsumexp(np.asarray(p_mass, np.float64)))

    r_buffer = np.zeros(r_buffer_size)
    pstar_buffer = np.zeros(r_buffer_size)
    r, pstar, k = 0.0, 0.0, 0
    for i in range(r_buffer_size):
        r += 1.0 - pstar
        r_buffer[i] = r
        while k < len(ratios) and ratios[k] < r:
            k += 1
        pc = p_zero + (p_cum_arr[k - 1] if k > 0 else 0.0)
        tc = t_cum[k - 1] if k > 0 else 0.0
        pstar = (1.0 - pc) * r + tc
        pstar_buffer[i] = pstar
    return r_buffer, pstar_buffer


def r_pstar_buffers(log_ratios, t_mass, p_mass, r_buffer_size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fast path: within an interval where r stays below the next ratio
    bound the recursion is affine with fixed point (1-T)/(1-P), so whole
    geometric slices fill at once."""
    ratios = np.exp(np.asarray(log_ratios, np.float64))
    t_cum_arr = np.exp(np.logaddexp.accumulate(np.asarray(t_mass, np.float64)))
    p_cum_arr = np.exp(np.logaddexp.accumulate(np.asarray(p_mass, np.float64)))
    p_zero = 1.0 - np.exp(_logsumexp(np.asarray(p_mass, np.float64)))

    r_buffer = np.zeros(r_buffer_size)
    pstar_buffer = np.zeros(r_buffer_size)
    r = 1.0
    r_buffer[0] = r
    i = 1
    for k, r_next in enumerate(ratios):
        if r_next < r:
            continue
        pc = p_zero + (p_cum_arr[k - 1] if k > 0 else 0.0)
        tc = t_cum_arr[k - 1] if k > 0 else 0.0
        fix = (1.0 - tc) / (1.0 - pc)
        # The recursion saturates at `fix`; a noisy empirical ratio above
        # it can never be crossed, so the slice runs to the buffer end.
        last = (k == len(ratios) - 1) or (r_next >= fix)
        if last:
            interval = r_buffer_size - i
        else:
            # Steps until r crosses r_next: geometric approach to `fix`.
            num = np.log((r_next - fix) / (r - fix))
            interval = max(1, min(r_buffer_size - i,
                                  int(np.ceil(num / np.log(pc)))))
        steps = 1.0 + np.arange(interval, dtype=np.float64)
        r_slice = fix - np.exp(np.log(pc) * steps + np.log(fix - r))
        r_buffer[i:i + interval] = r_slice
        pstar_buffer[i - 1:i + interval - 1] = \
            (1.0 - pc) * r_buffer[i - 1:i + interval - 1] + tc
        r = (pc ** interval) * (r - fix) + fix
        i += interval
        if i == r_buffer_size:
            pstar_buffer[-1] = (1.0 - pc) * r + tc
            break
        if last:
            raise CodingError("r buffer incomplete after all mass samples")
    return r_buffer, pstar_buffer


def _logsumexp(x):
    m = np.max(x)
    return m + np.log(np.sum(np.exp(x - m)))


# ---------------------------------------------------------------------------
# Coded sampling (host loop over device rounds)
# ---------------------------------------------------------------------------

class RejectionCodedSample(NamedTuple):
    index: int            # global stream index
    sample: torch.Tensor  # (D,) the standard-normal proposal chosen
    found: bool           # False only if the spillover budget ran out


def _round_terms(std_target: GaussianParams):
    """Per-dimension terms of ``log N(x; std_target) - log N(x; 0, 1)`` as
    XLA-CPU's fused round folds them: (A, b, c) with the ratio
    ``fma(fma(e, A, b), x, c)`` at normal x = sqrt(2) e, A = (1/s^2 - 1) *
    (-sqrt(2)/2)."""
    loc, scale = std_target
    inv = 1.0 / (scale * scale)
    A = (inv - 1.0) * _HALF_SQRT2_NEG
    b = loc * inv
    c = (loc * loc) * inv * -0.5 - _log_f32(scale)
    return A, b, c


def _round_ratios(terms, key: torch.Tensor, ridx: int, buf: int, D: int):
    """Log importance ratios (buf,) of proposal round ``ridx``: the stream
    fold_in(key, ridx) of (buf, D) standard normals, on the terms'
    device (the key is derived on the host)."""
    A, b, c = terms
    dev = A.device
    rkey = rng.fold_in(key, ridx).to(dev)
    out = torch.empty(buf, dtype=torch.float32, device=dev)
    for r0, r1 in _row_chunks(buf, D, dev):
        e, x = _tables(rkey, torch.arange(r0, r1, device=dev), D)
        out[r0:r1] = _row_sum(_fma(_fma(e, A, b), x, c))
    return out


def _first(accept: torch.Tensor):
    """(any, index of the first True), in one read of the device."""
    hit = torch.stack([accept.any().to(torch.int64),
                       torch.argmax(accept.to(torch.int8)).to(torch.int64)])
    any_acc, first = hit.tolist()
    return bool(any_acc), first


def rejection_sample(cfg: RejectionSamplerConfig, std_target: GaussianParams,
                     key: torch.Tensor, r_buffer: torch.Tensor,
                     pstar_buffer: torch.Tensor) -> RejectionCodedSample:
    """Draw proposal rounds until one is accepted.  ``std_target`` is the
    target standardized w.r.t. the coder; proposals are N(0, I); the
    float32 buffers store r_{i+1} / P*_{i+1}.

    Harsha acceptance for proposal i uses the state before it: accept iff
    u < (w - r_i) / (1 - P*_i) with r_0 = P*_0 = 0, so the buffers are
    consumed shifted by one (``rec_tpu``'s deliberate fix of the
    reference's pairing, which biases samples).  u is round r's
    ``jax.random.uniform`` of split(ukey)[1], ukey starting at
    fold_in(key, 0x0acc).  Past the r buffer, spillover rounds accept any
    proposal with ratio > log r_last, for at most ``max_spillover_rounds``
    rounds.  The sample is the decode replay of the accepted index, on
    the target's device.

    Keys are derived on the host: each derivation is one threefry
    evaluation of a single key, ~170 tiny kernels on a card."""
    buf = cfg.sample_buffer_size
    n_rounds = cfg.r_buffer_size // buf
    D = std_target.loc.shape[-1]
    dev = std_target.loc.device
    key = key.cpu()
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    r_shift = torch.cat([zero, r_buffer[:-1]])
    pstar_shift = torch.cat([zero, pstar_buffer[:-1]])
    terms = _round_terms(std_target)

    found, index, ridx = False, 0, 0
    ukey = rng.fold_in(key, UNIFORM_TAG)
    while ridx < n_rounds and not found:
        ukey, sub = rng.split(ukey)
        ratios = _round_ratios(terms, key, ridx, buf, D)
        u = rng.uniform(sub.to(dev), buf)
        s = slice(ridx * buf, (ridx + 1) * buf)
        accept = u < ((exp_f32(ratios) - r_shift[s]) / (1.0 - pstar_shift[s]))
        found, first = _first(accept)
        index = ridx * buf + first
        ridx += 1
    log_r_last = _log_f32(r_buffer[-1:])
    while not found and ridx < n_rounds + cfg.max_spillover_rounds:
        found, first = _first(_round_ratios(terms, key, ridx, buf, D)
                              > log_r_last)
        index = ridx * buf + first
        ridx += 1
    if not found:
        index = 0
    sample = decode_rejection_sample(cfg, key.to(dev), index, D)
    return RejectionCodedSample(index, sample, found)


def decode_rejection_sample(cfg: RejectionSamplerConfig, key: torch.Tensor,
                            index: int, dim: int) -> torch.Tensor:
    """index -> proposal: row index % buffer of round index // buffer, on
    the key's device (the round's key derived on the host)."""
    buf = cfg.sample_buffer_size
    rkey = rng.fold_in(key.cpu(), index // buf).to(key.device)
    return rng.normal_stream_row(rkey, index % buf, buf, dim)


# ---------------------------------------------------------------------------
# Stateful sampler facade (code-length bookkeeping)
# ---------------------------------------------------------------------------

def kl_f32(target: GaussianParams, coder: GaussianParams) -> float:
    """sum KL[target || coder] in nats as ``rec_tpu``'s eager
    ``jnp.sum(kl_divergence(...))`` gives it: XLA-CPU's float32 log, the
    sum in XLA-CPU's order."""
    return float(xla_sum_f32(kl_divergence(target, coder, log=_log_f32)))


class RejectionSampler:
    """Host-side facade: owns the averaged acceptance probabilities for
    code-length estimates (a running average over ``update`` calls, in
    float64, with a geometric spillover tail)."""

    def __init__(self, cfg: Optional[RejectionSamplerConfig] = None):
        self.cfg = cfg or RejectionSamplerConfig()
        self.average_count = 0.0
        self.acceptance_probabilities = np.zeros(self.cfg.r_buffer_size)
        self.spillover_probability = 0.0
        self.spillover_acceptance = 0.0
        self.initialized = False

    def _buffers(self, target: GaussianParams, coder: GaussianParams,
                 key: torch.Tensor):
        lr, tm, pm = (t.cpu().numpy() for t in estimate_mass(
            target, coder, key, self.cfg.mass_samples, self.cfg.oversampling))
        return r_pstar_buffers(lr, tm, pm, self.cfg.r_buffer_size)

    def update(self, target: GaussianParams, coder: GaussianParams,
               key: torch.Tensor) -> None:
        _, pstar = self._buffers(target, coder, key)
        acc = pstar - np.concatenate([[0.0], pstar[:-1]])
        self.acceptance_probabilities = (
            (self.acceptance_probabilities * self.average_count + acc)
            / (self.average_count + 1.0))
        self.average_count += 1.0
        self.spillover_probability = 1.0 - self.acceptance_probabilities.sum()
        self.spillover_acceptance = (
            self.acceptance_probabilities[-1]
            / (1.0 - self.acceptance_probabilities[:-1].sum()))
        self.initialized = True

    def get_codelength(self, index: int) -> float:
        if not self.initialized:
            raise CodingError("RejectionSampler not initialized; call update()")
        if index < self.cfg.r_buffer_size:
            return float(-np.log(self.acceptance_probabilities[index]))
        extra = index - self.cfg.r_buffer_size
        return float(-(np.log(self.spillover_probability)
                       + np.log(1.0 - self.spillover_acceptance) * extra
                       + np.log(self.spillover_acceptance)))

    def coded_sample(self, target: GaussianParams, coder: GaussianParams,
                     key: torch.Tensor) -> Tuple[int, torch.Tensor]:
        """Standardize, build the buffers, run the acceptance rounds.
        Returns (index, sample in coder coordinates)."""
        kl = kl_f32(target, coder)
        if kl >= self.cfg.max_kl:
            raise CodingError(
                f"KL divergence={kl:.2f} too high for rejection sampling")
        r_buf, pstar_buf = self._buffers(target, coder, key)
        std_target = GaussianParams((target.loc - coder.loc) / coder.scale,
                                    target.scale / coder.scale)
        dev = target.loc.device
        out = rejection_sample(
            self.cfg, std_target, key,
            torch.from_numpy(r_buf).to(dev, torch.float32),
            torch.from_numpy(pstar_buf).to(dev, torch.float32))
        if not out.found:
            raise CodingError("rejection sampling spillover budget exhausted")
        return out.index, coder.loc + coder.scale * out.sample

    def decode_sample(self, coder: GaussianParams, index: int,
                      key: torch.Tensor) -> torch.Tensor:
        eps = decode_rejection_sample(self.cfg, key.to(coder.loc.device),
                                      index, coder.loc.shape[-1])
        return coder.loc + coder.scale * eps
