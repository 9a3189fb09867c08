"""The sharded block codec on the card: ``sharded_encode_blocks`` over
every visible card (``make_mesh()``) and over ``[cuda:0] * 3`` gives the
one-card encode's indices, counts and sample bitwise, launches the
beam-search kernel once per mesh entry on each entry's card, and
``sharded_decode_blocks`` replays it bitwise; a mesh of 3 pads the 72
blocks of the flagship's serving batch to 75.  The CPU tests hold the
sharded codec against rec_tpu's.

This module imports no JAX, so it also runs on a GPU machine without it;
the tests' conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest tests/test_torch_parallel_card.py
"""

import numpy as np
import pytest
import torch

from rec_tpu_torch.coding import BeamSearchCoder
from rec_tpu_torch.coding.gauss import GaussianParams
from rec_tpu_torch.parallel import (Mesh, make_mesh, sharded_decode_blocks,
                                    sharded_encode_blocks)
from rec_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

CODER = BeamSearchCoder(n_beams=20, extra_samples=1.2, block_size=1000,
                        max_partitions=24)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _latent(dev, blocks=72):
    rs = np.random.RandomState(1)
    shape = (blocks, 1000)
    loc = torch.tensor(rs.randn(*shape) * 0.25, dtype=torch.float32)
    scale = torch.tensor(np.exp(rs.randn(*shape) * 0.1), dtype=torch.float32)
    return (GaussianParams(loc.to(dev), scale.to(dev)),
            GaussianParams(torch.zeros(shape, device=dev),
                           torch.ones(shape, device=dev)))


@pytest.mark.parametrize("which", ["visible", "repeat3"])
def test_sharded_equals_one_card(which):
    dev = _card()
    mesh = make_mesh() if which == "visible" else Mesh([dev] * 3)
    t, c = _latent(dev)
    want = CODER.encode(t, c, 11)
    before = profiling.counter("mega_beam.launches")
    got = sharded_encode_blocks(CODER, t, c, 11, mesh)
    by_card = profiling.counter("mega_beam.launches", since=before)
    assert by_card == {str(d): sum(e == d for e in mesh) for d in set(mesh)}
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.counts, want.counts)
    assert torch.equal(got.sample.view(torch.int32),
                       want.sample.view(torch.int32))
    dec = sharded_decode_blocks(CODER, c, want.indices, want.counts, 11,
                                mesh)
    assert torch.equal(dec.view(torch.int32), want.sample.view(torch.int32))
