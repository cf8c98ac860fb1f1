"""The control comes out not correct: in serving, the reference computed
in the precision below the configuration's and put in the program's
place; in training, the program's own bf16 path. Each fails one of its
cell's compared numbers, at 64x128, patch 32, on the CPU (the readings at
the cells' own sizes, on the card, are in PERF.md)."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.small import overrides


@pytest.mark.parametrize("cell", ["oneshot_s2d3d.batched_b64", "iterative_s2d3d.batched_b64"])
def test_serving_control_fails_where_the_program_passes(cell):
    c = harness.load_cell(cell, overrides=overrides(cell))
    rows = list(calibrate.serve_readings(c, [23, 29], "cpu"))
    limit = c.limits["limits"]["depth_gap"]
    assert all(r["depth_gap"] <= limit < r["control.depth_gap"] for r in rows), rows


def test_training_control_fails_one_number_where_the_program_passes():
    cell = "oneshot_s2d3d.train_b8"
    c = harness.load_cell(cell, overrides=overrides(cell))
    limits = c.limits["limits"]
    for r in calibrate.train_readings(c, [31], "cpu"):
        assert all(r[k] <= limits[k] for k in limits), r
        assert any(r[f"control.{k}"] > limits[k] for k in limits), r
        assert any(r[f"half_batch.{k}"] > limits[k] for k in limits), r


@pytest.mark.cuda
def test_serving_control_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell("oneshot_s2d3d.batched_b64")
    limit = c.limits["limits"]["depth_gap"]
    (row,) = calibrate.serve_readings(c, [37], "cuda")
    assert row["depth_gap"] <= limit < row["control.depth_gap"]
