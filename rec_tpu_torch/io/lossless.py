"""One photo's lossless ``.rec`` file from a lossless model: the coding
core that ``cli/compression_performance.py`` runs for each image and the
benchmark's photo cell drives.

``compress_to_file`` REC-encodes every stochastic group (the RVAE's res
blocks, ``LargeResNetVAE``'s two blocks; top-down), copies the indices and
counts to the host (``io.to_host``), runs the canonical single-image
decode the residual is scored against (``io/residual.py``'s contract),
codes the residual and writes the container.  With ``true_lossless``
off the file holds the latents alone and no decode runs.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import torch

from ..models.large_resnet_vae import LargeResNetVAE
from ..utils.profiling import span
from .container import write_rec
from .residual import encode_residual


class Compressed(NamedTuple):
    """What ``compress_to_file`` coded: per group, top-down, the numpy
    (indices (blocks, P), counts (blocks,)) the file holds; the groups'
    KLs; the encoder's reconstruction (1, H, W, 3) in [0, 1]; the residual
    payload (None without ``true_lossless``); the file's bytes; and host
    seconds by phase: ``encode`` (to the host copy included),
    ``residual`` (the canonical decode and the residual coder; with
    ``true_lossless`` only) and ``container_write``."""

    latents: List[tuple]
    kl: torch.Tensor
    reconstruction: torch.Tensor
    residual: Optional[bytes]
    nbytes: int
    seconds: dict


def decompress_latents(model, shape, latents, seed: int) -> torch.Tensor:
    """The reconstruction (1, H, W, 3) from top-down (indices, counts)."""
    if isinstance(model, LargeResNetVAE):
        return model.decompress(shape, latents, seed)
    return model.decompress(shape, *zip(*latents), seed)


def compress_to_file(model, path: str, image, seed: int, *,
                     block_size: int, max_index: int, codec: str = "ac",
                     true_lossless: bool = True) -> Compressed:
    """Code ``image`` (1, H, W, 3) in [-0.5, 0.5], the model's input, into
    the ``.rec`` file ``path`` with ``seed``."""
    x = torch.as_tensor(image, dtype=torch.float32, device=model.device)
    h, w = int(x.shape[1]), int(x.shape[2])
    t0 = time.perf_counter()
    comp = model.compress(x, seed)
    groups = (comp["latents"] if "latents" in comp
              else zip(comp["indices"], comp["counts"]))
    # The host waits here for the device's work of the whole encode.
    with span("io.to_host", card=model.device):
        latents = [(ind.cpu().numpy(), cnt.cpu().numpy())
                   for ind, cnt in groups]
    t1 = time.perf_counter()
    residual = None
    if true_lossless:
        # Scored against the decode replay's reconstruction (the encoder
        # embeds the decoder), so the file alone is lossless.
        x01 = x[0].cpu().numpy() + 0.5
        dec_recon = decompress_latents(model, (h, w), latents, seed)
        residual, _ = encode_residual(x01, dec_recon[0].cpu().numpy())
    t2 = time.perf_counter()
    nbytes = write_rec(path, seed=seed, image_shape=(h, w, 3),
                       block_size=block_size, max_index=max_index,
                       latents=latents, residual=residual, codec=codec)
    seconds = {"encode": t1 - t0, "residual": t2 - t1,
               "container_write": time.perf_counter() - t2}
    if not true_lossless:
        del seconds["residual"]
    return Compressed(latents, comp["kl"], comp["reconstruction"], residual,
                      nbytes, seconds)
