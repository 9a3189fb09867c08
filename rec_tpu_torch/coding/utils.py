"""Coding-layer errors and helpers (port of rec_tpu/coding/utils.py).

``rec_tpu`` routes every replay-critical float through ``pin`` (an XLA
optimization barrier) so that XLA cannot fuse, contract or re-associate the
decode chain differently in different programs.  The port needs no
counterpart: eager PyTorch runs each operation as its own kernel with its
own IEEE rounding, and never fuses or re-associates across operations, which
is exactly the guarantee ``pin`` buys from XLA.  The replay therefore avoids
fused ops (``addcmul``, ``torch.compile``) on its critical chain.
"""

from __future__ import annotations

import torch


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
