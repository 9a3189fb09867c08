"""Quadratic candidate scoring — port of ``rec_tpu/ops/beam_score.py``.

Per KL partition the beam search scores B x S combined candidate samples x
under the log density ratio of the auxiliary target and the cumulative
coder,

    score(x) = sum_d [log N(x_d; mu_d, s_d) - log N(x_d; nu_d, c_d)]
             = sum_d (a_d x_d + b_d) x_d + c_sum,

a per-dimension quadratic with coefficients from ``quadratic_coeffs``.
``score_candidates`` is the public entry point, as in ``rec_tpu.ops``; its
CUDA tensors go through the hand-written kernel ``csrc/beam_score.cu``
(any D: the D % 128 gate of the TPU kernel was a TPU tiling rule), CPU
tensors through the plain version ``score_candidates_ref``.
``launch_kernel`` counts its launches by card in the recorder's counter
``beam_score.launches`` (``utils.profiling.counter``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..coding.gauss import GaussianParams, quadratic_coeffs
from ..utils import profiling
from . import _build


@functools.lru_cache(maxsize=1)
def _load_kernel() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.build_kernel("beam_score"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beam_score_launch.restype = i
    lib.beam_score_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.beam_score_grid.restype = i
    lib.beam_score_grid.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    return lib


def grid(n: int, device=None) -> tuple:
    """(rows per CTA, CTAs) of the kernel's launch over ``n`` rows on
    ``device`` (default: the current card), as the kernel deals them."""
    rows, ctas = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = _load_kernel().beam_score_grid(n, ctypes.byref(rows),
                                            ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"beam_score grid query failed: CUDA error {rc}")
    return rows.value, ctas.value


def score_candidates_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         c_sum: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: sum over the last axis of (a x + b) x, plus
    c_sum."""
    return torch.sum((a * x + b) * x, dim=-1) + c_sum


def launch_kernel(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c_sum: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on x (N, D), a and b (D,) and a scalar c_sum,
    all float32 on one CUDA device; returns (N,) scores.  The output is
    allocated here; the kernel runs on the current stream."""
    N, D = x2d.shape
    dev = x2d.device
    if dev.type != "cuda":
        raise ValueError("beam_score kernel needs tensors on a CUDA device")
    for t, shape in ((x2d, (N, D)), (a, (D,)), (b, (D,)), (c_sum, ())):
        if (t.dtype != torch.float32 or t.device != dev or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError("beam_score kernel takes contiguous float32 x "
                             "(N, D), a and b (D,) and a scalar c_sum on one "
                             "CUDA device")
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    vec = int(D % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (x2d, a, b)))
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        rc = _load_kernel().beam_score_launch(
            x2d.data_ptr(), a.data_ptr(), b.data_ptr(), c_sum.data_ptr(),
            out.data_ptr(), N, D, vec,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beam_score kernel launch failed: CUDA error {rc}")
    profiling.add("beam_score.launches", str(dev))
    return out


def score_rows(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c_sum: torch.Tensor) -> torch.Tensor:
    """(N, D) candidate rows -> (N,) scores: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not x2d.is_cuda:
        return score_candidates_ref(x2d, a, b, c_sum)
    return launch_kernel(x2d.float().contiguous(), a.float().contiguous(),
                         b.float().contiguous(),
                         c_sum.float().reshape(()).contiguous())



def score_candidates(combined: torch.Tensor, aux_target: GaussianParams,
                     cum_coder: GaussianParams) -> torch.Tensor:
    """(B, S, D) candidates -> (B, S) log density-ratio scores under
    ``aux_target`` against ``cum_coder`` (each (D,))."""
    B, S, D = combined.shape
    a, b, c_sum = quadratic_coeffs(aux_target, cum_coder)
    return score_rows(combined.reshape(B * S, D), a, b, c_sum).reshape(B, S)
