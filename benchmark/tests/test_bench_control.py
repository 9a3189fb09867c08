"""``correct`` has to come out false under the control (the program a
precision step below the configuration's float32) and under each fault a
cell can have.  On the CPU at a small size the control is bfloat16
convolutions (the CPU has no TF32); the card runs TF32 at the cells' own
size (``planted.py``'s command line does the same for a dozen seeds)."""

from __future__ import annotations

import pytest
import torch

import planted
from conftest import tiny

CASES = [("rvae24.serve_b8", "bf16"), ("rvae24.serve_b8", "beams1"),
         ("rvae24.serve_b8", "prior"), ("rvae24.serve_b8", "index"),
         ("rvae24.serve_b8", "half_batch"), ("rvae24.serve_b8", "residual"),
         ("rvae24.serve_b8.x4", "shard"), ("rvae24.serve_b8.x4", "beams1"),
         ("lossy2.kodak_b1", "bf16"), ("lossy2.kodak_b1", "beams1"),
         ("lossy2.kodak_b1", "prior"),
         ("rvae24.train_b8", "bf16"), ("rvae24.train_b8", "frozen"),
         ("rvae24.train_b8", "half_loss")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(root, workload, fault):
    import run

    torch.set_num_threads(2)
    line = run.run_cell(root, workload, 2 ** 31 + 777, 0.3, False,
                        device="cpu", tweak=tiny,
                        around=planted.CONTROLS[fault])
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rvae24.serve_b8", "lossy2.kodak_b1",
                                      "rvae24.train_b8"])
def test_tf32_control_on_card(root, card, workload):
    import run

    line = run.run_cell(root, workload, 2 ** 31 + 4242, 5.0, False,
                        around=planted.tf32)
    assert not line["correct"], line["checks"]
