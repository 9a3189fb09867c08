"""Whole-model compression of many images per call (port of
rec_tpu/parallel/batch.py, lossless functions).

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
