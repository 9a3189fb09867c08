"""The scoring CUDA kernel (csrc/beam_score.cu) against its plain version
on the card: the error relative to sum_d |(a x + b) x| + |c| within
(D + 1) 2^-24, the worst case of a reordered float32 sum, at the paper
coder's shapes and at the edges of the kernel's dealing of rows (one row,
D = 1, an N that is not a multiple of the rows per CTA, D past one
1024-wide chunk, rows not 16-byte aligned); the same bits on a second
launch; at least one CTA per SM at the paper coder's shape.

This module imports no JAX, so it also runs on a GPU machine without it;
the tests' conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest tests/test_torch_beam_score_card.py
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rec_tpu_torch.ops import beam_score  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, N, D, offset=0):
    """x (N, D) as a contiguous view ``offset`` floats into its buffer, and
    a, b (D,) and c from a numpy seed."""
    rs = np.random.RandomState(N + D)
    flat = torch.tensor(rs.randn(offset + N * D), dtype=torch.float32,
                        device=dev)
    x = flat[offset:].view(N, D)
    a = torch.tensor(rs.randn(D), dtype=torch.float32, device=dev)
    b = torch.tensor(rs.randn(D), dtype=torch.float32, device=dev)
    return x, a, b, torch.tensor(1.5, device=dev)


def _check(x, a, b, c):
    got = beam_score.launch_kernel(x, a, b, c)
    ref = beam_score.score_candidates_ref(x, a, b, c)
    mag = torch.sum(torch.abs((a * x + b) * x), dim=-1) + torch.abs(c)
    assert got.shape == (x.shape[0],)
    rel = float(torch.max(torch.abs(got - ref) / mag))
    assert rel <= (x.shape[1] + 1) * 2 ** -24
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(720, 1024), (720, 1000), (37, 33),
                                 (1, 1024), (720, 1), (300, 2056),
                                 (5, 4099)])
def test_beam_score_kernel_matches_plain_version_on_card(dev, N, D):
    _check(*_inputs(dev, N, D))


@pytest.mark.cuda
def test_rows_not_a_multiple_of_the_rows_per_cta(dev):
    N = 721
    rows, ctas = beam_score.grid(N, dev)
    assert rows > 1 and N % rows != 0 and ctas == -(-N // rows)
    _check(*_inputs(dev, N, 1024))


@pytest.mark.cuda
def test_unaligned_rows_take_the_scalar_path(dev):
    x, a, b, c = _inputs(dev, 720, 1024, offset=1)
    assert x.data_ptr() % 16 != 0
    _check(x, a, b, c)


@pytest.mark.cuda
def test_two_launches_give_the_same_bits(dev):
    x, a, b, c = _inputs(dev, 720, 1000)
    first = _check(x, a, b, c)
    again = beam_score.launch_kernel(x, a, b, c)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_paper_coder_shape_covers_every_sm(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, ctas = beam_score.grid(720, dev)
    assert ctas >= sms and rows * ctas >= 720
