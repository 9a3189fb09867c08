"""The aux-variance-ratio fit on the card: its descent replayed as a CUDA
graph gives the ratio, steps and conditioned blocks of the same descent
launched eagerly, bit for bit, over three fits through one captured graph
(``chip_smoke.check_ratio_fit``).

This module imports no JAX, so it also runs on a GPU machine without it;
the tests' conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest tests/test_torch_ratio_fit_card.py
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.mark.cuda
def test_graph_descent_equals_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = chip_smoke.check_ratio_fit(torch.device("cuda"))
    assert got["graphs_captured"] == 1 and min(got["steps"]) >= 1
