"""Each mode's plain reference agrees with the port at 64x128, patch 32,
on the CPU, both in f32 from the benchmark's seeded weights."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, generator, harness, program, weights
from benchmark.modes import train as train_mode
from benchmark.reference import model as ref
from benchmark.tests.small import overrides


@pytest.mark.parametrize("cell", ["oneshot_s2d3d.batched_b64", "iterative_s2d3d.batched_b64"])
def test_serving_reference_matches_the_port(cell):
    c = harness.load_cell(cell, overrides=overrides(cell))
    cfg = c.config
    state = weights.make(cfg, 17, "cpu")
    model = program.build_model(cfg, {"trunk": "f32", "merge": "f32"}, state, "cpu").eval()
    rgb = generator.erp_pool(cfg, c.traffic, 3, "cpu")[0]
    with torch.inference_mode():
        ds = program.depths(model(rgb))
    rs = check.reference_depth(cfg, state, ref.Geometry(cfg, "cpu"), rgb)
    assert len(ds) == len(rs) == c.config["num_iters"]
    for d, r in zip(ds, rs):
        assert max(check.rel_l2(d, r)) < 1e-4
        assert r.abs().mean() > 1e-3  # a depth that is not degenerate


def test_training_reference_matches_the_port():
    cell = "oneshot_s2d3d.train_b8"
    c = harness.load_cell(cell, overrides=overrides(cell))
    cfg, tr = c.config, c.traffic
    state = weights.make(cfg, 19, "cpu")
    model = program.build_model(cfg, tr["precision"], state, "cpu")
    ts = program.train_state(model, tr)
    pool = generator.train_pool(cfg, tr, 4, "cpu")
    prog = train_mode.first_steps(ts, pool, 3, state, "cpu")
    refr = check.reference_train(cfg, tr["recipe"], state, pool[:3], "cpu")
    assert abs(prog["loss"][0] - refr["loss"][0]) <= 1e-5 * refr["loss"][0]
    gaps = check.train_gaps(prog, refr)
    assert gaps["loss_gap"] < 1e-3 and gaps["grad_gap"] < 1e-2 and gaps["change_gap"] < 0.05
