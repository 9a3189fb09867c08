"""The beam-search CUDA kernel against its plain version on the card, at
chip_smoke.py's edge shapes (``EDGES``: one block on the full grid, 133
blocks, B=S=128, P=160) and both streams: equal counts, indices in [0, S),
>= 95% per-index agreement, the objective gap of the replayed samples
within ``OBJECTIVE_TOL`` and the same indices on a second run.

This module imports no JAX, so it also runs on a GPU machine without it;
the tests' conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest tests/test_torch_mega_beam_card.py
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
@pytest.mark.parametrize("stream", ["fmix", "threefry"])
@pytest.mark.parametrize("case", range(len(chip_smoke.EDGES)),
                         ids=[e[0] for e in chip_smoke.EDGES])
def test_kernel_matches_plain_version_on_card(case, stream):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = chip_smoke.check_edge(torch.device("cuda"), case, stream)
    assert got["agreement"] >= 0.95
