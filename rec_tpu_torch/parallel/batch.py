"""Whole-model compression of many images per call (port of
rec_tpu/parallel/batch.py).

The returned callables take the arguments of rec_tpu's, minus ``params``
(the model holds its weights), and give outputs of the same shapes: a
leading image axis, and reconstructions (B, 1, H, W, C) as rec_tpu's vmap of
the batch-1 programs gives them.  Image i is keyed by ``seeds[i]`` exactly
as if encoded alone; its transmitted (indices, counts) replay bit for bit
through the canonical single-image ``decompress``.
"""

from __future__ import annotations

import torch


def make_batch_compress(model):
    """(images (B, H, W, C), seeds (B,)) -> dict of indices
    (B, N, blocks, P), counts (B, N, blocks), kl (B, N) and reconstruction
    (B, 1, H, W, C)."""

    def compress(images, seeds):
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=model.device)
        out = model.compress_batch(images, [int(s) for s in seeds])
        out["reconstruction"] = out["reconstruction"][:, None]
        return out

    return compress


def make_batch_decompress(model, shape):
    """(indices (B, N, blocks, P), counts (B, N, blocks), seeds (B,)) ->
    reconstructions (B, 1, H, W, C)."""

    def decompress(indices, counts, seeds):
        return model.decompress_batch(shape, indices, counts,
                                      [int(s) for s in seeds])[:, None]

    return decompress


def make_batch_rec_forward(model):
    """Lossy analogue of ``make_batch_compress`` for ``Large1LevelVAE`` and
    ``Large2LevelVAE``: (images (B, H, W, C) in [0, 1], seeds (B,)) -> dict
    of per-level (indices (B, blocks, P), counts (B, blocks)), per-level
    KLs (B,) and reconstructions (B, 1, H, W, C).  Each level of the batch
    is one block-codec call (one beam-search launch on the card); image i
    codes as ``rec_forward`` with ``seeds[i]`` and decodes through the
    canonical single-image ``rec_decode``."""

    def rec_forward(images, seeds):
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=model.device)
        out = model.rec_forward_batch(images, [int(s) for s in seeds])
        out["reconstruction"] = out["reconstruction"][:, None]
        return out

    return rec_forward


def make_batch_rec_decode(model, shape):
    """(per-level (indices (B, blocks, P), counts (B, blocks)), seeds (B,))
    -> reconstructions (B, 1, H, W, C)."""

    def rec_decode(latents, seeds):
        dev = model.device
        latents = [(torch.as_tensor(i, device=dev),
                    torch.as_tensor(c, device=dev)) for i, c in latents]
        return model.rec_decode_batch(shape, latents,
                                      [int(s) for s in seeds])[:, None]

    return rec_decode
