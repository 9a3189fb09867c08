"""The encode paths on the card (``chip_smoke.SCAN_CASES``): an S = 221
coder (Omega = 4.5, past the beam-search kernel's 128-wide selection tile)
warns and encodes on the scan path, and the paper config launches the
kernel; each has the CPU's counts, an encode sample bitwise equal to the
GPU decode and a GPU decode bitwise equal to the CPU decode.

This module imports no JAX, so it also runs on a GPU machine without it;
the tests' conftest.py configures JAX, so leave it out there:

    python -m pytest --noconftest tests/test_torch_scan_card.py
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
@pytest.mark.parametrize("case", range(len(chip_smoke.SCAN_CASES)),
                         ids=[c[0] for c in chip_smoke.SCAN_CASES])
def test_encode_path_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = chip_smoke.check_scan_dispatch(torch.device("cuda"), case)
    _, _, warns, kernel = chip_smoke.SCAN_CASES[case]
    assert got["warned"] == warns
    assert (got["kernel_launches"] > 0) == kernel
