"""Each traffic mix's control flow, through ``run.run_cell``, on a small
cell on the CPU: the window runs, the reference reads back what the port
produced and finds it correct."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny

CELLS = ("rvae24.serve_b8", "rvae24.serve_b8.x4", "lossy2.kodak_b1",
         "rvae24.train_b8")


@pytest.mark.parametrize("workload", CELLS)
def test_small_cell_is_correct(root, workload):
    import run

    torch.set_num_threads(2)
    line = run.run_cell(root, workload, 2 ** 31 + 12345, 0.3, False,
                        device="cpu", tweak=tiny)
    assert line["correct"], line["checks"]
    assert line["units_in_window"] > 0
    assert line["failed"] == 0
    assert set(line["metrics"]) >= {"setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
