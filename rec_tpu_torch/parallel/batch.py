"""Whole-model compression of many images per call, on one device or
sharded over a mesh (port of rec_tpu/parallel/batch.py).

The returned callables take the arguments of rec_tpu's, minus ``params``
(the model holds its weights), and give outputs of the same shapes: a
leading image axis, and reconstructions (B, 1, H, W, C) as rec_tpu's vmap of
the batch-1 programs gives them.  Image i is keyed by ``seeds[i]`` exactly
as if encoded alone; its transmitted (indices, counts) replay bit for bit
through the canonical single-image ``decompress``.

With a ``mesh`` (``parallel.mesh.Mesh``) the batch, whose length must be a
multiple of the mesh, splits into contiguous equal shares: each entry runs
the model's batched call on its share with a replica of the model on its
device (``replicate``), so one entry codes as one process of a
multi-process run with one device each, and the outputs come back to the
host stacked in global row order.  Images never communicate: nothing moves
between devices but the inputs in and the outputs out.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, replicate, shard_rows


def shard_images(images, seeds, mesh: Mesh):
    """Each entry's share of a padded global batch: its images (float32, on
    its device) and its seeds (ints)."""
    ims = shard_rows(torch.as_tensor(images, dtype=torch.float32), mesh)
    sds = np.split(np.asarray(seeds).reshape(-1), len(mesh))
    return [(im, [int(s) for s in sd]) for im, sd in zip(ims, sds)]


def _shard_args(*args, mesh: Mesh):
    """Each entry's rows of the batch arguments (arrays or tensors, the
    seeds last, or lists of per-level (indices, counts) pairs), on the
    host side: the entry's call moves them."""
    n = len(args[-1])
    if n % len(mesh):
        raise ValueError(f"batch {n} is not a multiple of the mesh "
                         f"({len(mesh)} entries)")
    share = n // len(mesh)

    def rows(x, sl):
        if isinstance(x, list):
            return [tuple(a[sl] for a in pair) for pair in x]
        return x[sl] if isinstance(x, torch.Tensor) else np.asarray(x)[sl]

    return [[rows(a, slice(i * share, (i + 1) * share)) for a in args]
            for i in range(len(mesh))]


def _join_rows(parts):
    """Per-entry output trees (dicts, lists, tuples of tensors) joined along
    their leading axis, on the host."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.cpu() for p in parts])
    if isinstance(first, dict):
        return {k: _join_rows([p[k] for p in parts]) for k in first}
    return type(first)(_join_rows(list(z)) for z in zip(*parts))


def _over_mesh(one, model, mesh, shard=_shard_args):
    """``(*batch_args) -> outputs`` of ``one(model, *batch_args)``: on the
    model's device without a mesh; with one, ``one`` runs once per entry
    on the entry's arguments from ``shard`` and on its replica, and the
    outputs join in row order."""
    if mesh is None:
        return lambda *args: one(model, *args)
    replicas = replicate(model, mesh)

    def run(*args):
        return _join_rows([one(m, *a) for m, a in
                           zip(replicas, shard(*args, mesh=mesh))])

    return run


def _compress(model, images, seeds):
    images = torch.as_tensor(images, dtype=torch.float32, device=model.device)
    out = model.compress_batch(images, [int(s) for s in seeds])
    out["reconstruction"] = out["reconstruction"][:, None]
    return out


def make_batch_compress(model, mesh: Mesh = None):
    """(images (B, H, W, C), seeds (B,)) -> dict of indices
    (B, N, blocks, P), counts (B, N, blocks), kl (B, N) and reconstruction
    (B, 1, H, W, C); on the host when sharded over ``mesh``."""
    return _over_mesh(_compress, model, mesh, shard_images)


def make_batch_decompress(model, shape, mesh: Mesh = None):
    """(indices (B, N, blocks, P), counts (B, N, blocks), seeds (B,)) ->
    reconstructions (B, 1, H, W, C)."""

    def decompress(m, indices, counts, seeds):
        return m.decompress_batch(shape, indices, counts,
                                  [int(s) for s in seeds])[:, None]

    return _over_mesh(decompress, model, mesh)


def _rec_forward(model, images, seeds):
    images = torch.as_tensor(images, dtype=torch.float32, device=model.device)
    out = model.rec_forward_batch(images, [int(s) for s in seeds])
    out["reconstruction"] = out["reconstruction"][:, None]
    return out


def make_batch_rec_forward(model, mesh: Mesh = None):
    """Lossy analogue of ``make_batch_compress`` for ``Large1LevelVAE``,
    ``Large2LevelVAE`` and ``Large4LevelVAE``: (images (B, H, W, C) in
    [0, 1], seeds (B,)) -> dict of per-level (indices (B, blocks, P),
    counts (B, blocks)), per-level KLs (B,) and reconstructions
    (B, 1, H, W, C).  Each level of a device's rows is one block-codec call
    (one beam-search launch on the card); image i codes as ``rec_forward``
    with ``seeds[i]`` and decodes through the canonical single-image
    ``rec_decode``."""
    return _over_mesh(_rec_forward, model, mesh, shard_images)


def make_batch_rec_decode(model, shape, mesh: Mesh = None):
    """(per-level (indices (B, blocks, P), counts (B, blocks)), seeds (B,))
    -> reconstructions (B, 1, H, W, C)."""

    def rec_decode(m, latents, seeds):
        dev = m.device
        latents = [(torch.as_tensor(i, device=dev),
                    torch.as_tensor(c, device=dev)) for i, c in latents]
        return m.rec_decode_batch(shape, latents,
                                  [int(s) for s in seeds])[:, None]

    return _over_mesh(rec_decode, model, mesh)
