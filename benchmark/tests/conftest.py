"""The benchmark's own tests: small cells on the CPU, and the controls at
the cells' own size on a card (marked ``cuda``; they skip without one)."""

from __future__ import annotations

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (os.path.join(BENCH, "tests"), BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def tiny(cell):
    """The cell at a size the CPU runs in seconds: every width cut, the
    coder's beam and blocks shrunk, small images."""
    cfg = copy.deepcopy(cell.config)
    traffic = dict(cell.traffic)
    if "level_1_filters" in cfg["model"]:
        cfg["model"].update(level_1_filters=8, level_2_filters=8)
        cfg["image_shape"] = [128, 128, 3]
        traffic.update(images=3, check_photos=2, rate=50.0)
    else:
        cfg["model"].update(num_res_blocks=2, deterministic_filters=8,
                            stochastic_filters=4)
        cfg["image_shape"] = [8, 8, 3]
        devices = traffic.get("devices", 1)
        traffic["batch"] = 2 * devices if devices > 1 else 4
    if "coder" in cfg:
        cfg["coder"].update(n_beams=3, extra_samples=1.0, block_size=64,
                            max_partitions=6)
        if "level_1_filters" in cfg["model"]:
            # Small latents hold little KL: a smaller Omega gives their
            # blocks several partitions, so that the beams matter.
            cfg["coder"].update(kl_per_partition=0.5, extra_samples=4.0)
    return cell._replace(config=cfg, traffic=traffic)


@pytest.fixture(scope="session")
def root():
    return ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
