"""Carry the lossy VAEs' weights between a flax params tree and the port,
both ways.

The port's modules carry flax's names (``analysis.conv_0.kernel_rdft``,
``level_2_prior.prior_base``, ...), so the tree maps onto the state dict by
a walk: nested keys join with ".", and only the plain 4-D ``kernel`` leaves
change layout (flax's HWIO <-> the port's OIHW); with ``dense`` a Dense
layer's ``kernel`` (in, out) is also ``nn.Linear``'s ``weight``, transposed
(the MNIST VAEs' rule).  The tree is nested dicts
of numpy arrays, with or without the outer ``{"params": ...}`` level; both
directions only move and transpose float32 values, so a round trip gives
the same bits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn


def _is_hwio(name: str, a: np.ndarray, hwio_leaves) -> bool:
    return name.rsplit(".", 1)[-1] in hwio_leaves and a.ndim == 4


def from_numpy_tree(tree: Mapping, hwio_leaves=("kernel",), dense=False
                    ) -> Dict[str, torch.Tensor]:
    """Flax params tree of a lossy VAE (1, 2 or 4 levels) -> the
    port model's state dict; the 4-D leaves named in ``hwio_leaves``
    change layout, and with ``dense`` every ``kernel`` leaf is a
    transposed ``weight``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + ".")
                continue
            a = np.asarray(value, np.float32)
            if dense and key == "kernel":
                name, a = f"{prefix}weight", np.ascontiguousarray(a.T)
            elif _is_hwio(name, a, hwio_leaves):
                a = a.transpose(3, 2, 0, 1)
            sd[name] = torch.tensor(a)

    walk(tree.get("params", tree), "")
    return sd


def to_numpy_tree(tensors: Union[nn.Module, Mapping[str, torch.Tensor]],
                  hwio_leaves=("kernel",), dense=False) -> dict:
    """The inverse of ``from_numpy_tree``: a model or a state dict -> the
    ``{"params": ...}`` tree flax's ``model.init`` gives, float32 numpy."""
    if isinstance(tensors, nn.Module):
        tensors = tensors.state_dict()
    p: dict = {}
    for name, t in tensors.items():
        a = t.detach().cpu().numpy().astype(np.float32, copy=False)
        *path, leaf = name.split(".")
        if dense and leaf == "weight":
            leaf, a = "kernel", np.ascontiguousarray(a.T)
        elif _is_hwio(name, a, hwio_leaves):
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        node = p
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a
    return {"params": p}


def load_flax_params(model: nn.Module, tree: Mapping) -> None:
    """Load a flax params tree into ``model`` (strict: every leaf of the
    tree and every parameter of the model must match)."""
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in
                           from_numpy_tree(tree).items()}, strict=True)
