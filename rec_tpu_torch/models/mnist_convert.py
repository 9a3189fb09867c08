"""Carry the MNIST VAEs' weights between a flax params tree and the port,
both ways: the lossy converter's walk (the port's modules carry flax's
names, nested keys join with "."), where a Dense layer's ``kernel``
(in, out) is the transpose of ``nn.Linear``'s ``weight``; ``bias``,
``inducing_points``, ``mog_loc`` and ``mog_log_scale`` carry over as they
are.  Trees of optimizer moments map the same way.  Both directions only
move and transpose float32 values, so a round trip gives the same bits;
``CheckpointManager(..., convert=mnist_convert)`` reads and writes the
models' checkpoints with it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
import torch.nn as nn

from .lossy import convert as _walk


def from_numpy_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (or moments) tree -> the port model's state dict."""
    return _walk.from_numpy_tree(tree, dense=True)


def to_numpy_tree(tensors: Union[nn.Module, Mapping[str, torch.Tensor]]
                  ) -> dict:
    """The inverse of ``from_numpy_tree``: the ``{"params": ...}`` tree
    flax's ``model.init`` gives, float32 numpy."""
    return _walk.to_numpy_tree(tensors, dense=True)


def load_flax_params(model: nn.Module, tree: Mapping) -> None:
    """Load a flax params tree into ``model`` (strict)."""
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in
                           from_numpy_tree(tree).items()}, strict=True)
