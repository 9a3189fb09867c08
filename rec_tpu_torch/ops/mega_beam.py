"""Whole-partition beam-search encode — one cooperative CUDA kernel per
latent-block set.

Port of ``rec_tpu/ops/mega_beam.py`` (the Pallas kernel ``_kernel``).  The
kernel, ``csrc/mega_beam.cu``, runs the entire partition chain of N latent
blocks — candidate generation, scoring, top-B selection and the beam-carry
update — as one persistent grid over every SM of the card: each partition
step scores the live (block, beam, candidate) rows spread over all warps,
selects with one warp per block, and regenerates the winners, with a grid
barrier between the phases.  What stays outside the kernel is the
index-independent precompute (KL counts, the variance schedule, the
quadratic score coefficients ``qa``/``qb`` and the aux scales), written
here in plain torch as ``rec_tpu`` leaves it to XLA, and the launch plan
(grid size, block order by count, scratch), which is plain Python.

Selection-only semantics: the kernel chooses indices; the reported sample is
always the decode replay (``coding/beam_search._replay_flat``), so its
floats need to be faithful, not exact.

``mega_encode_blocks`` launches the kernel for CUDA tensors (or raises) and
uses the plain PyTorch version ``mega_encode_blocks_ref`` only for CPU
tensors.  ``launch_kernel`` counts its launches by card (``"cuda:k"``) in
the recorder's counter ``mega_beam.launches``
(``utils.profiling.counter``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..coding import rng
from ..coding.gauss import GaussianParams, auxiliary_target, kl_divergence
from ..coding.partition import num_partitions, schedule_table
from ..utils import profiling
from . import _build

_GRID_COLS = 128   # the Pallas kernel's (S_pad, 128) selection tile
_BIG = 2 ** 30
_STREAMS = {"fmix": 0, "threefry": 1}
# Budget for one call's (N, P, D_pad) float32 score coefficients qa, qb and
# ascale, as in rec_tpu (whose TPU compiler failed on a 1.7 GiB schedule):
# larger block sets are encoded in equal chunks of the block axis, which
# leaves every block's stream unchanged.
_SCHED_LIMIT_BYTES = 1 << 29


# The kernel's launch geometry (``csrc/mega_beam.cu``: kThreads, kGroup),
# checked against the built library by ``grid``.
THREADS = 256
GROUP = 4          # candidates one warp scores together


@functools.lru_cache(maxsize=1)
def _load_kernel() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build_all(_build.CODER)["mega_beam"])
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.mega_beam_launch.restype = i
    lib.mega_beam_launch.argtypes = [p] * 14 + [i] * 7 + [p]
    lib.mega_beam_occupancy.restype = i
    lib.mega_beam_occupancy.argtypes = [i, ip, ip, ip, ip, ip]
    return lib


def grid_ctas(sms: int, ctas_per_sm: int, cooperative: bool = True) -> int:
    """The cooperative grid: every CTA the card holds at once, one wave."""
    if not cooperative:
        raise RuntimeError("mega_beam needs a card that takes cooperative "
                           "launches")
    if sms < 1 or ctas_per_sm < 1:
        raise RuntimeError(f"mega_beam kernel does not fit on the card: "
                           f"{sms} SMs x {ctas_per_sm} CTAs")
    return sms * ctas_per_sm


@functools.lru_cache(maxsize=None)
def grid(device_index: int, stream: str) -> tuple:
    """(CTAs, threads per CTA) of the kernel's grid on a card, from its SM
    count and the kernel's occupancy (one query per card and stream)."""
    sms, per_sm, threads, group, coop = (ctypes.c_int() for _ in range(5))
    with torch.cuda.device(device_index):
        rc = _load_kernel().mega_beam_occupancy(
            _STREAMS[stream], ctypes.byref(sms), ctypes.byref(per_sm),
            ctypes.byref(threads), ctypes.byref(group), ctypes.byref(coop))
    if rc != 0:
        raise RuntimeError(f"mega_beam occupancy query failed: CUDA error "
                           f"{rc}")
    if (threads.value, group.value) != (THREADS, GROUP):
        raise RuntimeError(f"mega_beam library has {threads.value} threads "
                           f"per CTA and groups of {group.value}, the "
                           f"wrapper plans {THREADS} and {GROUP}")
    return grid_ctas(sms.value, per_sm.value, bool(coop.value)), THREADS


def live_plan(counts: torch.Tensor, P: int):
    """Blocks by step count, longest first (ties by block), and for each
    step t the number of blocks still live (count > t): the live blocks of
    step t are the first ``live[t]`` of ``order``.  Both int32, on the
    counts' device, with no host synchronisation."""
    n = torch.clamp(counts.to(torch.int64), 0, P)
    order = torch.sort(n, descending=True, stable=True).indices
    steps = torch.arange(P, device=counts.device)
    live = (n[None, :] > steps[:, None]).sum(dim=1)
    return order.to(torch.int32), live.to(torch.int32)


def scratch_shapes(N: int, B: int, S: int, P: int, D: int) -> dict:
    """The kernel's scratch, double-buffered over steps where a phase reads
    one buffer and writes the other: {name: (shape, dtype)}."""
    return {
        "beams": ((N, 2, B, D), torch.float32),
        "hist": ((N, 2, B, P), torch.int32),
        "hashes": ((N, 2, B), torch.int32),
        "skeys": ((N, 2, B, 2), torch.int32),
        "scores": ((N, B * S), torch.float32),
        "sel": ((N, 2, B), torch.int32),
    }


def precompute(targets: GaussianParams, coders: GaussianParams,
                kl_per_partition: float, P: int, ratios=None):
    """Index-independent precompute: counts (N,) int32 and the (N, P, D)
    float32 score coefficients qa, qb and aux scales (``_mega_call``'s XLA
    prologue).  The per-step constant term of the score is dropped: it
    shifts every candidate equally."""
    kls = torch.sum(kl_divergence(targets, coders), dim=-1)
    n = torch.clamp(num_partitions(kls, kl_per_partition), max=P)
    w, c_after = schedule_table(n, P, ratios, device=targets.loc.device)
    tgt = GaussianParams(targets.loc[:, None, :], targets.scale[:, None, :])
    cod = GaussianParams(coders.loc[:, None, :], coders.scale[:, None, :])
    aux_t = auxiliary_target(tgt, cod, c_after[..., None] * cod.var)
    cum_scale = torch.sqrt(c_after)[..., None] * cod.scale
    inv_n = 1.0 / torch.square(aux_t.scale)
    inv_d = 1.0 / torch.square(cum_scale)
    qa = -0.5 * (inv_n - inv_d)
    qb = aux_t.loc * inv_n
    ascale = torch.sqrt(w)[..., None] * cod.scale
    # Degenerate steps (zero aux variance) give inf/NaN coefficients: keep
    # everything finite so the step scores all candidates equally and the
    # selection's NaN guard picks a deterministic in-range index.
    fix = functools.partial(torch.nan_to_num, nan=0.0, posinf=0.0,
                            neginf=0.0)
    return n, fix(qa).contiguous(), fix(qb).contiguous(), \
        fix(ascale).contiguous()


def _check_config(n_beams: int, n_samples: int):
    if n_beams > _GRID_COLS or n_samples > _GRID_COLS:
        raise ValueError(
            f"the beam-search kernel's selection tile is (S, 128): needs "
            f"n_beams<=128 and n_samples<=128, got B={n_beams}, "
            f"S={n_samples}")


def launch_kernel(counts: torch.Tensor, bkeys: torch.Tensor,
                  qa: torch.Tensor, qb: torch.Tensor, ascale: torch.Tensor,
                  *, n_beams: int, n_samples: int, stream: str
                  ) -> torch.Tensor:
    """Launch the CUDA kernel on precomputed inputs (``precompute``):
    counts (N,), raw block keys (N, 2), and (N, P, D) float32 qa, qb and
    ascale on one CUDA device.  Returns the (N, P) int32 indices.  Scratch
    is allocated here; the kernel allocates nothing and runs on the current
    stream as one cooperative grid over every SM."""
    N, P, D = qa.shape
    dev = qa.device
    if dev.type != "cuda":
        raise ValueError("mega_beam kernel needs tensors on a CUDA device")
    for x in (qa, qb, ascale):
        if (x.dtype != torch.float32 or x.device != dev
                or x.shape != (N, P, D) or not x.is_contiguous()):
            raise ValueError("qa/qb/ascale must be contiguous (N, P, D) "
                             "float32 tensors on one CUDA device")
    if bkeys.shape != (N, 2) or counts.shape != (N,):
        raise ValueError(f"counts (N,) and bkeys (N, 2) expected, got "
                         f"{tuple(counts.shape)} and {tuple(bkeys.shape)}")
    cnt = counts.to(dev, torch.int32).contiguous()
    keys = bkeys.to(dev, torch.int64)
    keys = torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys)
    keys = keys.to(torch.int32).contiguous()
    B, S = n_beams, n_samples
    n_ctas, _ = grid(dev.index if dev.index is not None
                     else torch.cuda.current_device(), stream)
    order, live = live_plan(cnt, P)
    # Entries past a block's count stay zero; the kernel writes the rest.
    out = torch.zeros((N, P), dtype=torch.int32, device=dev)
    scratch = [torch.empty(shape, dtype=dtype, device=dev)
               for shape, dtype in scratch_shapes(N, B, S, P, D).values()]
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        rc = _load_kernel().mega_beam_launch(
            cnt.data_ptr(), keys.data_ptr(), qa.data_ptr(), qb.data_ptr(),
            ascale.data_ptr(), order.data_ptr(), live.data_ptr(),
            out.data_ptr(), *(x.data_ptr() for x in scratch),
            N, D, B, S, P, n_ctas, _STREAMS[stream],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mega_beam kernel launch failed: CUDA error {rc}")
    profiling.add("mega_beam.launches", str(dev))
    return out


def mega_encode_blocks(targets: GaussianParams, coders: GaussianParams,
                       bkeys: torch.Tensor, *, kl_per_partition: float,
                       n_beams: int, n_samples: int, max_partitions: int,
                       stream: str, ratios=None):
    """Fused whole-partition beam-search encode of N latent blocks.

    targets/coders: (N, D) GaussianParams; bkeys: (N, 2) raw block keys.
    Returns (indices (N, max_partitions) int32, counts (N,) int32) with the
    stream contract of ``beam_search.encode_blocks``.  CUDA tensors launch
    the kernel; CPU tensors run ``mega_encode_blocks_ref``.  Block sets
    whose score coefficients exceed ``_SCHED_LIMIT_BYTES`` run in equal
    chunks of the block axis (``rec_tpu/ops/mega_beam.py:214-264``)."""
    _check_config(n_beams, n_samples)
    if stream not in _STREAMS:
        raise ValueError(f"unknown stream {stream!r}")
    kw = dict(kl_per_partition=kl_per_partition, n_beams=n_beams,
              n_samples=n_samples, max_partitions=max_partitions,
              stream=stream, ratios=ratios)
    N, D = targets.loc.shape
    per_block = 3 * max_partitions * (-(-D // 128) * 128) * 4
    chunk = max(1, min(N, _SCHED_LIMIT_BYTES // per_block))
    if chunk >= N:
        return _encode_call(targets, coders, bkeys, **kw)
    # Pad to a chunk multiple with target == coder == N(0, 1) blocks (KL 0,
    # dropped after the call) and encode equal slices of the block axis.
    pad = -N % chunk

    def padded(x, fill):
        return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])

    tp = GaussianParams(padded(targets.loc, 0.0), padded(targets.scale, 1.0))
    cp = GaussianParams(padded(coders.loc, 0.0), padded(coders.scale, 1.0))
    kp = padded(bkeys, 0)
    inds, ns = [], []
    for lo in range(0, N + pad, chunk):
        sl = slice(lo, lo + chunk)
        ind, n = _encode_call(GaussianParams(tp.loc[sl], tp.scale[sl]),
                              GaussianParams(cp.loc[sl], cp.scale[sl]),
                              kp[sl], **kw)
        inds.append(ind)
        ns.append(n)
    return torch.cat(inds)[:N], torch.cat(ns)[:N]



def _encode_call(targets, coders, bkeys, *, kl_per_partition, n_beams,
                 n_samples, max_partitions, stream, ratios):
    """One call over a block set: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    with profiling.span("kernel.mega_beam", card=targets.loc.device,
                        blocks=targets.loc.shape[0]):
        if not targets.loc.is_cuda:
            return mega_encode_blocks_ref(
                targets, coders, bkeys, kl_per_partition=kl_per_partition,
                n_beams=n_beams, n_samples=n_samples,
                max_partitions=max_partitions, stream=stream, ratios=ratios)
        n, qa, qb, ascale = precompute(targets, coders, kl_per_partition,
                                        max_partitions, ratios)
        out = launch_kernel(n, bkeys, qa, qb, ascale, n_beams=n_beams,
                            n_samples=n_samples, stream=stream)
        return out, n


def mega_encode_blocks_ref(targets: GaussianParams, coders: GaussianParams,
                           bkeys: torch.Tensor, *, kl_per_partition: float,
                           n_beams: int, n_samples: int, max_partitions: int,
                           stream: str, ratios=None):
    """Plain PyTorch version of the kernel: the same semantics in eager
    torch, vectorised over blocks.

    Float32 scores; the top-B selection of ``rec_tpu``'s Pallas kernel over
    its (S_pad, 128) tile, column b = beam b: the maximum wins, ties go to
    the lowest ``s*128 + b`` (candidate-major), a NaN score makes the pick
    (beam 0, candidate 0), and once every remaining score is -inf the pick
    is the lowest -inf slot of the tile, padding included.  A padding
    column's beam reads clamp to beam B-1, as the Pallas interpreter's
    dynamic slices do."""
    _check_config(n_beams, n_samples)
    N, D = targets.loc.shape
    P, B, S = max_partitions, n_beams, n_samples
    S_pad = -(-S // 8) * 8
    dev = targets.loc.device
    n, qa, qb, ascale = precompute(targets, coders, kl_per_partition, P,
                                    ratios)
    keys = bkeys.to(dev, torch.int64)
    beams = torch.zeros((N, B, D), dtype=torch.float32, device=dev)
    hist = torch.zeros((N, B, P), dtype=torch.int64, device=dev)
    hashes = rng.fnv_init((N, B), device=dev)
    rows = torch.arange(N, device=dev)[:, None]
    flat = torch.arange(S_pad * _GRID_COLS, device=dev)
    ctr = torch.arange(S * D, dtype=torch.int64, device=dev)
    n_max = int(n.max()) if N else 0
    for t in range(min(n_max, P)):
        skey = rng.step_key(keys, t)                             # (N, 2)
        bk = rng.beam_stream_key(skey[:, None, :], hashes)      # (N, B, 2)
        eps = rng.stream_bits(bk, ctr, stream)
        eps = rng._bits_to_normal_f32(eps).reshape(N, B, S, D)
        asc = ascale[:, t, None, None, :]
        x = beams[:, :, None, :] + asc * eps
        sc = torch.sum((qa[:, t, None, None, :] * x
                        + qb[:, t, None, None, :]) * x, dim=-1)  # (N, B, S)
        grid = torch.full((N, S_pad, _GRID_COLS), -torch.inf, device=dev)
        grid[:, :S, :B] = sc.transpose(1, 2)
        if t == 0:
            grid[:, :, 1:] = -torch.inf
        grid = grid.reshape(N, -1)
        picks = []
        for _ in range(B):
            m = torch.amax(grid, dim=1, keepdim=True)  # NaN-propagating
            f = torch.where(grid == m, flat, _BIG).amin(dim=1)
            f = torch.where(f >= _BIG, 0, f)
            picks.append(f)
            grid[torch.arange(N, device=dev), f] = -torch.inf
        f = torch.stack(picks, dim=1)                            # (N, B)
        parent = torch.clamp(f % _GRID_COLS, max=B - 1)
        cand = f // _GRID_COLS
        eps_row = rng.normal_stream_row(bk[rows, parent], cand, S, D,
                                        stream=stream)           # (N, B, D)
        new_beams = beams[rows, parent] + ascale[:, t, None, :] * eps_row
        new_hist = hist[rows, parent].clone()
        new_hist[:, :, t] = cand
        new_hashes = rng.fnv_step(hashes[rows, parent], cand)
        live = (t < n)[:, None]
        beams = torch.where(live[..., None], new_beams, beams)
        hist = torch.where(live[..., None], new_hist, hist)
        hashes = torch.where(live, new_hashes, hashes)
    return hist[:, 0].to(torch.int32), n
