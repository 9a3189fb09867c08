"""Frozen copy of rec_tpu_torch/coding/utils.py for the benchmark's reference
(the replay has to give the program's bits; the copy may not change
with the program).

Coding-layer errors and helpers (port of rec_tpu/coding/utils.py).

``rec_tpu`` routes every replay-critical float through ``pin`` (an XLA
optimization barrier) so that XLA cannot fuse, contract or re-associate the
decode chain differently in different programs.  The port needs no
counterpart: eager PyTorch runs each operation as its own kernel with its
own IEEE rounding, and never fuses or re-associates across operations, which
is exactly the guarantee ``pin`` buys from XLA.  The replay therefore avoids
fused ops (``addcmul``, ``torch.compile``) on its critical chain.

``xla_sum_f32`` adds float32 values in the order XLA-CPU's ``jnp.sum``
does, which makes the code lengths (and the importance coder's candidate
scores) the same bits on the CPU, on the GPU and in ``rec_tpu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# XLA-CPU's tree-reduction window (its reduce-window rewrite of a sum).
SUM_WINDOW = 32


class CodingError(Exception):
    """Raised on codec misconfiguration (KL overflow, bad buffers, ...)."""


def tree_where(pred: torch.Tensor, new, old):
    """Select whole tuples of tensors by a per-row predicate (copied from
    rec_tpu/coding/importance.py): ``pred`` has the leading shape of every
    leaf and broadcasts over the rest."""
    def sel(n, o):
        p = pred.reshape(pred.shape + (1,) * (n.dim() - pred.dim()))
        return torch.where(p, n, o)

    return type(new)(sel(n, o) for n, o in zip(new, old))


def sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 sum of ``x`` along ``dim``, added one slice at a time from
    0.0 in index order (one eager add per slice, so the same bits on every
    device)."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def sum_pads(n: int) -> tuple:
    """(low, high) zero padding of ``n`` > SUM_WINDOW values to whole
    windows: the pad is split low ``pad // 2``, high ``pad - pad // 2``."""
    pad = (-n) % SUM_WINDOW
    return pad // 2, pad - pad // 2


def xla_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """Sum float32 ``x`` over its last axis in XLA-CPU's order.

    Up to SUM_WINDOW (32) values are added in order from 0.0.  More are
    padded with zeros to a multiple of 32 (``sum_pads``), each window of
    32 is added in order, and the window sums are summed again by this
    rule.  Read off the HLO XLA-CPU compiles for ``jnp.sum`` of f32[197]:
    ``reduce-window size=32 stride=32 pad=13_14`` followed by a ``reduce``
    of the 7 window sums; it also holds for row sums of (C, D) arrays (a
    ``pad=0_0x12_12`` window at D = 1000)."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        return sum_in_order(x, -1)
    lo, hi = sum_pads(n)
    windows = F.pad(x, (lo, hi)).unflatten(-1, (-1, SUM_WINDOW))
    return xla_sum_f32(sum_in_order(windows, -1))
