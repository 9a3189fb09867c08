"""The benchmark's frozen bound of the beam-search kernel against
``chip_smoke.py``'s at its main shape and at the serving and lossy
shapes, for both streams."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from benchlib import yardstick

RATES = {"lane_ops_per_s": 132 * 128 * 1980e6,
         "int_ops_per_s": 132 * 64 * 1980e6}


@pytest.fixture(scope="module")
def smoke(root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_bench", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("stream", ["fmix", "threefry"])
@pytest.mark.parametrize("shape", ["MAIN", "serve", "lossy"])
def test_bound_matches_chip_smoke(smoke, stream, shape):
    dims = {"MAIN": smoke.MAIN, "serve": dict(N=72, D=1000, B=20, S=36, P=24),
            "lossy": dict(N=302, D=1000, B=10, S=20, P=24)}[shape]
    counts = np.random.default_rng(3).integers(1, dims["P"] + 1, dims["N"])
    ref = smoke.mega_beam_bound(counts, dims["N"], dims["D"], dims["B"],
                                dims["S"], dims["P"], stream, RATES)
    got = yardstick.mega_beam_bound(counts, dims["N"], dims["D"], dims["B"],
                                    dims["S"], dims["P"], stream, RATES)
    for key in ("bound_ops_ms", "bound_int_ms", "bound_bytes_ms",
                "bound_ms"):
        assert got[key] == ref[key]


def test_launches_sum(smoke):
    counts = [np.full(9, 7), np.full(9, 3)]
    cfg = {"block_size": 1000, "n_beams": 20, "n_samples": 36,
           "max_partitions": 24, "stream": "fmix"}
    one = [yardstick.mega_beam_bound(c, 9, 1000, 20, 36, 24, "fmix",
                                     RATES)["bound_ms"] for c in counts]
    assert yardstick.launches_bound_ms(counts, cfg, RATES) == sum(one)
