"""Import a flax ``BidirectionalResNetVAE`` params tree into the port.

The tree is nested dicts of numpy arrays (``jax.device_get(params)``), with
or without the outer ``{"params": ...}`` level.  Kernels go HWIO -> OIHW;
the ``nn.scan`` stacks ``infer_stack``/``gen_stack`` (leading axis =
res block) split into the port's per-block modules; ``generative_base`` and
``likelihood_log_scale`` carry over.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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


def from_numpy_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree -> state dict of ``BidirectionalResNetVAE``."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    sd.update(_conv_entries("first_infer_conv", p["first_infer_conv"]))
    sd.update(_conv_entries("last_gen_conv", p["last_gen_conv"]))
    for stack, prefix in (("infer_stack", "infer_blocks"),
                          ("gen_stack", "gen_blocks")):
        layers = p[stack]
        depth = np.asarray(next(iter(layers.values()))["v"]).shape[0]
        for g in range(depth):
            for name, leaf in layers.items():
                sd.update(_conv_entries(f"{prefix}.{g}.{name}", leaf, g))
    for name in ("generative_base", "likelihood_log_scale"):
        sd[name] = torch.tensor(np.asarray(p[name], np.float32))
    return sd


def load_flax_params(model, tree: Mapping) -> None:
    """Load a flax params tree into ``model`` (strict) and mark it
    initialised."""
    sd = {k: v.to(model.device) for k, v in from_numpy_tree(tree).items()}
    model.load_state_dict(sd, strict=True)
    model.initialized = True
