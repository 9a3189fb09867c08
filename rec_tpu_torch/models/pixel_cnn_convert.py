"""Carry ``PixelCNN`` weights between a flax params tree and the port, both
ways: the lossy converter's walk (the port's modules carry flax's names:
``first_conv``, ``res_block_<i>.conv_<j>``, ``loc_head``,
``log_scale_head``; nested keys join with "."), where each convolution's
4-D ``v`` goes HWIO <-> OIHW and ``log_scale`` and ``bias`` carry over as
they are.  Both directions only move and transpose float32 values, so a
round trip gives the same bits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
import torch.nn as nn

from .lossy import convert as _walk


def from_numpy_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree -> the port model's state dict."""
    return _walk.from_numpy_tree(tree, hwio_leaves=("v",))


def to_numpy_tree(tensors: Union[nn.Module, Mapping[str, torch.Tensor]]
                  ) -> dict:
    """The inverse of ``from_numpy_tree``: the ``{"params": ...}`` tree
    flax's ``model.init`` gives, float32 numpy."""
    return _walk.to_numpy_tree(tensors, hwio_leaves=("v",))


def load_flax_params(model: nn.Module, tree: Mapping) -> None:
    """Load a flax params tree into ``model`` (strict) and mark it
    initialised."""
    model.load_state_dict({k: v.to(model.device) for k, v in
                           from_numpy_tree(tree).items()}, strict=True)
    model.initialized = True
