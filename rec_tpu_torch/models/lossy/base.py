"""The lossy models' common interface and their ``.rec`` helpers (port of
rec_tpu/models/lossy/base.py).

A model exposes
  * ``forward(images, noise)``: the training forward, the posterior
    samples drawn with the given standard normals (one NHWC array per
    level, in coding order);
  * ``rec_forward_batch(images, seeds)``: every level REC-coded for B
    images with one ``coder.encode_batch`` per level (one beam-search
    launch per level on the card), per-image seeds as ``rec_forward``;
  * ``rec_decode_batch(shape, latents, seeds)``: the reconstructions from
    the transmitted indices;
and ``rec_forward``/``rec_decode`` are those at B = 1, the canonical
single-image programs.  Images, latents and reconstructions are NHWC at
every public function; each level's latent goes to the coder as (H, W, C),
the order in which ``rec_tpu`` flattens it before the split permutation.

``compress_to_file``/``decompress_from_file`` wire a model through the
``.rec`` container, warning when a latent block hits the coder's partition
budget.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...coding import Coder
from ...coding.gauss import GaussianParams
from ...device import set_deterministic
from ...io import read_rec, write_rec
from ...utils.profiling import span


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def bhwc(p: GaussianParams) -> GaussianParams:
    """NCHW distribution -> (B, H, W, C), each image in the coder's
    flatten order."""
    return GaussianParams(nhwc(p.loc), nhwc(p.scale))


class LossyModel(nn.Module):
    """Device handling and the single-image programs of a lossy VAE."""

    coder: Optional[Coder]

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _enter(self) -> None:
        if self.device.type == "cuda":
            set_deterministic()

    def _noise(self, noise) -> List[torch.Tensor]:
        """The per-level standard normals as NCHW float32 tensors on the
        model's device."""
        return [nchw(torch.as_tensor(n, dtype=torch.float32,
                                     device=self.device)) for n in noise]

    def latent_shapes(self, height: int, width: int) -> list:
        """(h, w, channels) of each latent level of an image, coding
        order."""
        raise NotImplementedError

    def rec_forward_batch(self, images: torch.Tensor, seeds) -> dict:
        raise NotImplementedError

    def rec_decode_batch(self, shape, latents, seeds) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def rec_forward(self, images: torch.Tensor, seed: int) -> dict:
        """REC-encode one image (1, H, W, 3) in [0, 1]: per-level
        (indices (blocks, P), counts (blocks,)), per-level KLs and the
        reconstruction (1, H, W, 3)."""
        if images.shape[0] != 1:
            raise ValueError("rec_forward expects batch size 1")
        out = self.rec_forward_batch(images, [seed])
        return {"reconstruction": out["reconstruction"],
                "latents": [(i[0], c[0]) for i, c in out["latents"]],
                "kls": [k[0] for k in out["kls"]]}

    @torch.no_grad()
    def rec_decode(self, shape: Sequence[int], latents, seed: int
                   ) -> torch.Tensor:
        """The reconstruction (1, H, W, 3) of one image from its per-level
        (indices, counts) and seed; ``shape`` = (H, W)."""
        dev = self.device
        batched = [(torch.as_tensor(i, device=dev)[None],
                    torch.as_tensor(c, device=dev)[None])
                   for i, c in latents]
        return self.rec_decode_batch(shape, batched, [seed])


def saturated_blocks(counts, budget: int) -> int:
    """Latent blocks whose partition count hit the budget; ``counts`` is
    one array of block counts per level."""
    return sum(int(np.sum(np.asarray(c) == budget)) for c in counts)


def compress_to_file(model: LossyModel, file_path: str, image, seed: int,
                     block_size: int, max_index: int, codec: str = "ac"
                     ) -> torch.Tensor:
    """REC-encode ``image`` (H, W, 3) in [0, 1] into a ``.rec`` file;
    returns the reconstruction (H, W, 3).  Warns when a block hit the
    coder's ``max_partitions`` (its coded sample is truncated)."""
    image = torch.as_tensor(image, dtype=torch.float32, device=model.device)
    out = model.rec_forward(image[None], seed)
    # The host waits here for the device's work of the whole encode.
    with span("io.to_host", card=model.device):
        latents = [(ind.cpu().numpy(), cnt.cpu().numpy())
                   for ind, cnt in out["latents"]]
    budget = model.coder.max_partitions
    saturated = saturated_blocks([c for _, c in latents], budget)
    if saturated:
        warnings.warn(
            f"{saturated} latent block(s) hit max_partitions={budget}; the "
            "coded sample is truncated and reconstruction quality degrades "
            "— use a coder with a larger max_partitions", stacklevel=2)
    write_rec(file_path, seed=seed, image_shape=tuple(image.shape),
              block_size=block_size, max_index=max_index, latents=latents,
              codec=codec)
    return out["reconstruction"][0]


def decompress_from_file(model: LossyModel, file_path: str,
                         max_partitions: int) -> torch.Tensor:
    """Inverse of ``compress_to_file``: the reconstruction (H, W, 3)."""
    seed, image_shape, _, latents = read_rec(file_path,
                                             max_partitions=max_partitions)
    return model.rec_decode(image_shape[:2], latents, seed)[0]
