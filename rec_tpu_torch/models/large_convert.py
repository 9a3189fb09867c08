"""Carry ``LargeResNetVAE`` weights between a flax params tree and the
port, both ways: the lossy converter's walk (the port's modules carry
flax's names, nested keys join with "."), where the weight-norm
convolutions' ``v`` leaves change layout as the plain ``kernel`` leaves do
(flax's HWIO <-> the port's OIHW).  ``SignalConv2D``'s ``kernel_rdft`` and
``bias``, GDN's ``beta_reparam`` and ``gamma_reparam``, ``generative_base``
and ``likelihood_log_scale`` keep flax's layouts.  Both directions only
move and transpose float32 values, so a round trip gives the same bits;
``CheckpointManager(..., convert=large_convert)`` writes and reads the
model's checkpoints with it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
import torch.nn as nn

from .lossy import convert as _walk

_HWIO_LEAVES = ("kernel", "v")


def from_numpy_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (or moments) tree -> state dict of ``LargeResNetVAE``."""
    return _walk.from_numpy_tree(tree, _HWIO_LEAVES)


def to_numpy_tree(tensors: Union[nn.Module, Mapping[str, torch.Tensor]]
                  ) -> dict:
    """The inverse of ``from_numpy_tree``: the ``{"params": ...}`` tree
    flax's ``model.init`` gives, float32 numpy."""
    return _walk.to_numpy_tree(tensors, _HWIO_LEAVES)


def load_flax_params(model, tree: Mapping) -> None:
    """Load a flax params tree into ``model`` (strict) and mark it
    initialised."""
    model.load_state_dict({k: v.to(model.device) for k, v in
                           from_numpy_tree(tree).items()}, strict=True)
    model.initialized = True
