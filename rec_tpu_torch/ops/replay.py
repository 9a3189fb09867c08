"""The beam-search coder's decode replay: one CUDA launch per call.

The replay of N blocks (``coding/beam_search._replay_flat``, the sample of
every encode and decode) is, per block and live step, the winning stream's
key (block key, step, FNV history hash, or the shared pool's tag), that
stream's row of standard normals read from ``rng.normal_table``, and the
schedule-weighted chain of fused multiply-adds of
``partition.replay_contract``.  ``replay_blocks`` launches the kernel
``csrc/replay.cu`` for CUDA tensors (or raises) and runs the plain version
``replay_blocks_ref``, that chain in eager PyTorch, for CPU tensors.  Both
give ``rec_tpu``'s bits.  The kernel replaces no TPU kernel: ``rec_tpu``'s
replay is jnp inside the jitted coder.  ``launch_kernel`` counts its
launches by card (``"cuda:k"``) in the recorder's counter
``replay.launches`` (``utils.profiling.counter``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..coding import rng
from ..coding.gauss import GaussianParams
from ..coding.partition import replay_contract
from ..utils import profiling
from ..utils.profiling import span
from . import _build

_STREAMS = {"fmix": 0, "threefry": 1}


@functools.lru_cache(maxsize=1)
def _load_kernel() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build_all(_build.CODER)["replay"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.replay_launch.restype = i
    lib.replay_launch.argtypes = [p] * 8 + [i] * 5 + [p]
    return lib


def _replay_keys(bkeys: torch.Tensor, indices: torch.Tensor,
                 counts: torch.Tensor, P: int, shared_pool: bool
                 ) -> torch.Tensor:
    """Per-step winning-beam stream keys (N, P, 2) — pure integer.  The
    history hash h_{t+1} = fnv(h_t, idx_t) is frozen past ``count``;
    ``shared_pool`` streams are the pool keys, which need no hash."""
    N = bkeys.shape[0]
    dev = bkeys.device
    steps = torch.arange(P, dtype=torch.int64, device=dev)
    skeys = rng.step_key(bkeys[:, None, :], steps[None, :])     # (N, P, 2)
    if shared_pool:
        return rng.pool_key(skeys)
    idx = indices.to(torch.int64)
    h = rng.fnv_init((N,), device=dev)
    hs = []
    for t in range(P):
        hs.append(h)
        h = torch.where(t < counts, rng.fnv_step(h, idx[:, t]), h)
    hashes = torch.stack(hs, dim=1)                              # (N, P)
    return rng.beam_stream_key(skeys, hashes)


def replay_blocks_ref(coders: GaussianParams, w: torch.Tensor,
                      indices: torch.Tensor, counts: torch.Tensor,
                      bkeys: torch.Tensor, *, stream: str,
                      shared_pool: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the eager chain: the winning
    streams' keys, their rows of normals, then ``replay_contract``.
    coders (N, D), schedule weights ``w`` (N, P), indices (N, P), counts
    (N,) clamped to P, raw block keys (N, 2); returns (N, D) float32."""
    D = coders.loc.shape[1]
    with span("replay.keys"):
        keys = _replay_keys(bkeys, indices, counts, w.shape[1], shared_pool)
    with span("replay.normals"):
        eps = rng.normal_stream_row(keys, indices.to(torch.int64),
                                    0,  # rows are addressed directly
                                    D, stream=stream)            # (N, P, D)
    with span("replay.contract"):
        return replay_contract(coders, w, eps)


def _check_args(loc, scale, w, indices, counts, bkeys) -> torch.device:
    """The kernel's argument contract: dtypes, shapes, contiguity, then
    one CUDA device for all.  Returns that device."""
    if loc.dim() != 2 or w.dim() != 2:
        raise ValueError(f"loc (N, D) and w (N, P) expected, got "
                         f"{tuple(loc.shape)} and {tuple(w.shape)}")
    (N, D), P = loc.shape, w.shape[1]
    want = {"loc": (loc, torch.float32, (N, D)),
            "scale": (scale, torch.float32, (N, D)),
            "w": (w, torch.float32, (N, P)),
            "indices": (indices, torch.int32, (N, P)),
            "counts": (counts, torch.int64, (N,)),
            "bkeys": (bkeys, torch.int64, (N, 2))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype:
            raise ValueError(f"replay: {name} must be {dtype}, got "
                             f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"replay: {name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"replay: {name} must be contiguous")
    devices = {x.device for x, _, _ in want.values()}
    dev = loc.device
    if len(devices) != 1 or dev.type != "cuda":
        raise ValueError(f"replay kernel needs every tensor on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    return dev


def launch_kernel(loc: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                  indices: torch.Tensor, counts: torch.Tensor,
                  bkeys: torch.Tensor, *, stream: str, shared_pool: bool
                  ) -> torch.Tensor:
    """Launch the CUDA kernel: loc and scale (N, D) float32, ``w`` (N, P)
    float32, indices (N, P) int32, counts (N,) int64, raw block keys (N, 2)
    int64, all contiguous on one CUDA device.  Returns the (N, D) float32
    replay.  The output is allocated here; the kernel allocates nothing and
    runs on the current stream of the tensors' card.  An empty replay
    launches nothing and is not counted."""
    if stream not in _STREAMS:
        raise ValueError(f"unknown stream {stream!r}")
    dev = _check_args(loc, scale, w, indices, counts, bkeys)
    (N, D), P = loc.shape, w.shape[1]
    out = torch.empty_like(loc)
    if out.numel() == 0:
        return out
    table = rng.normal_table(dev)
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        rc = _load_kernel().replay_launch(
            loc.data_ptr(), scale.data_ptr(), w.data_ptr(),
            indices.data_ptr(), counts.data_ptr(), bkeys.data_ptr(),
            table.data_ptr(), out.data_ptr(), N, D, P, _STREAMS[stream],
            int(shared_pool), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"replay kernel launch failed: CUDA error {rc}")
    profiling.add("replay.launches", str(dev))
    return out


def replay_blocks(coders: GaussianParams, w: torch.Tensor,
                  indices: torch.Tensor, counts: torch.Tensor,
                  bkeys: torch.Tensor, *, stream: str, shared_pool: bool
                  ) -> torch.Tensor:
    """The replay of N blocks (``replay_blocks_ref``'s arguments): one
    kernel launch for CUDA tensors, the plain version for CPU tensors."""
    if not coders.loc.is_cuda:
        return replay_blocks_ref(coders, w, indices, counts, bkeys,
                                 stream=stream, shared_pool=shared_pool)
    with span("replay.kernel"):
        return launch_kernel(
            coders.loc.contiguous(), coders.scale.contiguous(),
            w.contiguous(), indices.to(torch.int32).contiguous(),
            counts.to(torch.int64).contiguous(),
            bkeys.to(torch.int64).contiguous(), stream=stream,
            shared_pool=shared_pool)
