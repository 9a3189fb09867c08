"""The rejection coder on the card: XLA-CPU's float32 exp, the mass
estimate at the reference's defaults and ``RejectionCoder`` in both modes
give the CPU's bits on the GPU (encode indices and samples, decode both
ways).  The CPU tests hold the CPU against rec_tpu.

This module imports no JAX, so it also runs on a GPU machine without it;
the tests' conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest tests/test_torch_rejection_card.py
"""

import numpy as np
import pytest
import torch

from rec_tpu_torch.coding import rejection as trej
from rec_tpu_torch.coding import rng
from rec_tpu_torch.coding.gauss import GaussianParams
from rec_tpu_torch.coding.rejection_coder import RejectionCoder
from rec_tpu_torch.ops.threefry_normal import exp_f32

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(x):
    return x.contiguous().view(torch.int32).cpu()


def _pair(D, seed, dev):
    rs = np.random.RandomState(seed)
    t = (0.5 * rs.randn(D), np.exp(0.2 * rs.randn(D) - 0.7))
    c = (0.1 * rs.randn(D), np.exp(0.1 * rs.randn(D)))
    return tuple(GaussianParams(*(torch.tensor(a, dtype=torch.float32,
                                               device=dev) for a in p))
                 for p in (t, c))


def _cpu(p):
    return GaussianParams(p.loc.cpu(), p.scale.cpu())


def test_exp_gpu_equals_cpu():
    dev = _card()
    x = torch.empty(1 << 24).uniform_(-90.0, 90.0,
                                      generator=torch.Generator()
                                      .manual_seed(0))
    x = torch.cat([x, torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), 0.0, -87.5, 88.75])])
    want, got = exp_f32(x), exp_f32(x.to(dev)).cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(_bits(got[keep]), _bits(want[keep]))


def test_estimate_mass_gpu_equals_cpu():
    dev = _card()
    t, c = _pair(1000, 1, dev)
    key = rng.root_key(5, device=dev)
    gpu = trej.estimate_mass(t, c, key)
    cpu = trej.estimate_mass(_cpu(t), _cpu(c), key.cpu())
    for g, w in zip(gpu, cpu):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("update", [False, True])
def test_rejection_coder_gpu_equals_cpu(update):
    dev = _card()
    t, c = _pair(200, 2, dev)
    cfg = trej.RejectionSamplerConfig(sample_buffer_size=2000,
                                      r_buffer_size=2000)
    gpu_rc, cpu_rc = RejectionCoder(sampler_config=cfg), RejectionCoder(
        sampler_config=cfg)
    gi, gs = gpu_rc.encode_block(t, c, seed=7, update_sampler=update)
    ci, cs = cpu_rc.encode_block(_cpu(t), _cpu(c), seed=7,
                                 update_sampler=update)
    assert gi == ci
    assert torch.equal(_bits(gs), _bits(cs))
    if update:
        np.testing.assert_array_equal(gpu_rc.sampler.acceptance_probabilities,
                                      cpu_rc.sampler.acceptance_probabilities)
        return
    assert len(gi) > 1
    assert torch.equal(_bits(gpu_rc.decode_block(c, gi, seed=7)), _bits(gs))
    assert torch.equal(_bits(cpu_rc.decode_block(_cpu(c), gi, seed=7)),
                       _bits(gs))
