"""One latent's blocks coded across the entries of a mesh (port of
rec_tpu/parallel/codec.py).

Blocks are independent after the split, so the per-block codec shards with
no communication: the whole-latent split (split permutation, block keys)
runs on the caller's device exactly as ``coder.encode`` runs it, the block
axis is padded to a multiple of the mesh with dummy blocks where target ==
coder (loc 0, scale 1: nothing to code), each entry codes its contiguous
share on its own device (one beam-search kernel launch per entry on the
card) with the keys of the global block indices, and the indices, counts
and replayed samples come back to the caller's device in block order, the
padding dropped.  The result is bitwise that of ``coder.encode`` and
``coder.decode`` on one device; it works for every ``_BlockCoder``
(``BeamSearchCoder`` and ``GaussianCoder``).
"""

from __future__ import annotations

import torch

from ..coding import rng
from ..coding.coder import CodedLatent, _batch1
from ..coding.gauss import GaussianParams
from ..coding.partition import merge_batch, split_coders
from .mesh import Mesh


def _pad_blocks(g: GaussianParams, n_pad: int) -> GaussianParams:
    if n_pad == 0:
        return g
    D = g.loc.shape[-1]
    return GaussianParams(
        torch.cat([g.loc, g.loc.new_zeros((n_pad, D))]),
        torch.cat([g.scale, g.scale.new_ones((n_pad, D))]))


def _shares(n_blocks: int, mesh: Mesh):
    """(padding, slices): the block axis padded to a multiple of the mesh,
    and each entry's contiguous share of it."""
    n_pad = (-n_blocks) % len(mesh)
    share = (n_blocks + n_pad) // len(mesh)
    return n_pad, [slice(i * share, (i + 1) * share)
                   for i in range(len(mesh))]


def _setup(coder, shape, seed, device, mesh):
    """The split of one latent of ``shape`` with ``seed`` on ``device``
    (``coder.encode``'s), the keys of the block axis padded to a multiple
    of the mesh (each block keyed by its global index), and the entries'
    slices."""
    plan, perms, _ = coder._setup(shape, [seed], device)
    n_pad, slices = _shares(plan.num_blocks, mesh)
    blocks = torch.arange(plan.num_blocks + n_pad, dtype=torch.int64,
                          device=device)
    bkeys = rng.block_key(rng.root_key(seed, device), blocks)
    return plan, perms, bkeys, n_pad, slices


def sharded_encode_blocks(coder, target: GaussianParams,
                          coding: GaussianParams, seed: int, mesh: Mesh
                          ) -> CodedLatent:
    """Encode one latent of any shape with its blocks sharded over
    ``mesh``: (indices (num_blocks, P), counts (num_blocks,), sample (the
    latent's shape)), on the target's device, bitwise ``coder.encode``'s."""
    shape, home = target.loc.shape, target.loc.device
    plan, perms, bkeys, n_pad, slices = _setup(coder, shape, seed, home,
                                               mesh)
    t = _pad_blocks(split_coders(_batch1(target), plan, perms), n_pad)
    c = _pad_blocks(split_coders(_batch1(coding), plan, perms), n_pad)
    ratios = coder._batch_ratios()
    parts = []
    for dev, sl in zip(mesh, slices):
        parts.append(coder._encode_blocks(
            GaussianParams(t.loc[sl].to(dev), t.scale[sl].to(dev)),
            GaussianParams(c.loc[sl].to(dev), c.scale[sl].to(dev)),
            bkeys[sl].to(dev), ratios))
    nb = plan.num_blocks

    def gather(field):
        return torch.cat([getattr(p, field).to(home) for p in parts])[:nb]

    sample = merge_batch(gather("sample"), shape, plan, perms)[0]
    return CodedLatent(gather("indices"), gather("count"), sample)


def sharded_decode_blocks(coder, coding: GaussianParams, indices, counts,
                          seed: int, mesh: Mesh) -> torch.Tensor:
    """Replay one latent with its blocks sharded over ``mesh``, on the
    coder Gaussian's device, bitwise ``coder.decode``'s."""
    shape, home = coding.loc.shape, coding.loc.device
    plan, perms, bkeys, n_pad, slices = _setup(coder, shape, seed, home,
                                               mesh)
    c = _pad_blocks(split_coders(_batch1(coding), plan, perms), n_pad)
    indices = torch.as_tensor(indices, device=home)
    counts = torch.as_tensor(counts, device=home)
    indices = torch.cat([indices, indices.new_zeros((n_pad,)
                                                    + indices.shape[1:])])
    counts = torch.cat([counts, counts.new_ones((n_pad,))])
    ratios = coder._batch_ratios()
    parts = [coder._decode_blocks(
        GaussianParams(c.loc[sl].to(dev), c.scale[sl].to(dev)),
        indices[sl].to(dev), counts[sl].to(dev), bkeys[sl].to(dev), ratios)
        for dev, sl in zip(mesh, slices)]
    samples = torch.cat([p.to(home) for p in parts])[:plan.num_blocks]
    return merge_batch(samples, shape, plan, perms)[0]
