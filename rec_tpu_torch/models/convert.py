"""Carry ``BidirectionalResNetVAE`` weights between a flax params tree and
the port, both ways.

The tree is nested dicts of numpy arrays (``jax.device_get(params)``), with
or without the outer ``{"params": ...}`` level.  Kernels go HWIO <-> OIHW;
the ``nn.scan`` stacks ``infer_stack``/``gen_stack`` (leading axis = res
block) split into, or stack from, the port's per-block modules, the IAF's
nested ``iaf_posterior_multiconv/{conv,head}_<i>`` included;
``generative_base`` and ``likelihood_log_scale`` carry over.  Trees of
optimizer moments (optax's ``mu``/``nu``) have the params tree's structure
and map the same way.  Both directions only move and transpose float32
values, so a round trip gives the same bits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

_STACKS = (("infer_stack", "infer_blocks"), ("gen_stack", "gen_blocks"))


def _conv_entries(prefix: str, leaf: Mapping, index=None
                  ) -> Dict[str, torch.Tensor]:
    def pick(a, perm=None):
        a = np.asarray(a, np.float32)
        a = a if index is None else a[index]
        return torch.tensor(a if perm is None else a.transpose(perm))

    out = {f"{prefix}.v": pick(leaf["v"], (3, 2, 0, 1)),
           f"{prefix}.log_scale": pick(leaf["log_scale"])}
    if "bias" in leaf:
        out[f"{prefix}.bias"] = pick(leaf["bias"])
    return out


def _convs(node: Mapping, prefix: str = ""):
    """(dotted name, leaf dict) of every convolution under ``node``: a
    mapping that holds ``v`` is one."""
    for name, child in node.items():
        if "v" in child:
            yield prefix + name, child
        else:
            yield from _convs(child, f"{prefix}{name}.")


def from_numpy_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (or moments) tree -> state dict of
    ``BidirectionalResNetVAE``."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    sd.update(_conv_entries("first_infer_conv", p["first_infer_conv"]))
    sd.update(_conv_entries("last_gen_conv", p["last_gen_conv"]))
    for stack, prefix in _STACKS:
        convs = dict(_convs(p[stack]))
        depth = np.asarray(next(iter(convs.values()))["v"]).shape[0]
        for g in range(depth):
            for name, leaf in convs.items():
                sd.update(_conv_entries(f"{prefix}.{g}.{name}", leaf, g))
    for name in ("generative_base", "likelihood_log_scale"):
        sd[name] = torch.tensor(np.asarray(p[name], np.float32))
    return sd


def _numpy(t: torch.Tensor, leaf: str) -> np.ndarray:
    a = t.detach().cpu().numpy().astype(np.float32, copy=False)
    return a.transpose(2, 3, 1, 0) if leaf == "v" else a


def to_numpy_tree(tensors: Union[nn.Module, Mapping[str, torch.Tensor]]
                  ) -> dict:
    """The inverse of ``from_numpy_tree``: a model, or a name -> tensor
    mapping with its state dict's names (parameters, EMA shadows, optimizer
    moments), -> the ``{"params": ...}`` tree flax's ``model.init`` gives,
    as float32 numpy arrays."""
    if isinstance(tensors, nn.Module):
        tensors = tensors.state_dict()
    p: dict = {}
    stacked: Dict[str, Dict[str, Dict[str, list]]] = {}
    blocks = dict((prefix, stack) for stack, prefix in _STACKS)
    for name, t in tensors.items():
        parts = name.split(".")
        if parts[0] in blocks:
            g, conv, leaf = int(parts[1]), tuple(parts[2:-1]), parts[-1]
            leaves = stacked.setdefault(blocks[parts[0]], {}).setdefault(
                conv, {}).setdefault(leaf, [])
            if len(leaves) != g:
                raise ValueError(f"{name}: blocks out of order")
            leaves.append(_numpy(t, leaf))
        elif len(parts) == 2:
            p.setdefault(parts[0], {})[parts[1]] = _numpy(t, parts[1])
        else:
            p[name] = _numpy(t, name)
    for stack, layers in stacked.items():
        node = p[stack] = {}
        for conv, leaves in layers.items():
            parent = node
            for key in conv[:-1]:
                parent = parent.setdefault(key, {})
            parent[conv[-1]] = {leaf: np.stack(arrs)
                                for leaf, arrs in leaves.items()}
    return {"params": p}


def load_flax_params(model, tree: Mapping) -> None:
    """Load a flax params tree into ``model`` (strict) and mark it
    initialised."""
    sd = {k: v.to(model.device) for k, v in from_numpy_tree(tree).items()}
    model.load_state_dict(sd, strict=True)
    model.initialized = True
