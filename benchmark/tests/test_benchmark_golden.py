"""Numbers the benchmark gave before its model kinds moved into files of
their own (``benchmark/models/<model>.py``, ``benchmark/reference/<model>.py``),
which the same seed has to give still: the weights bit for bit at the CPU
tests' sizes, the model's FLOPs and the hand kernels' bounds at each
cell's own shapes (the reference on the meta device, the tables on the
host), and one seed's check values at the CPU tests' sizes, one thread."""

from __future__ import annotations

import hashlib

import pytest
import torch

from benchmark import calibrate, harness, weights, yardstick
from benchmark.tests.small import overrides

SERVING = ["oneshot_s2d3d.batched_b64", "iterative_s2d3d.batched_b64"]
TRAIN = "oneshot_s2d3d.train_b8"
WEIGHTS = {  # sha256 of each tensor's name, shape and bytes, in order; seed 17
    "oneshot_s2d3d": "3ffb5517bd014b16eb6d247175c8fdb56d24c39facd14f646204d9b5b2134d7e",
    "iterative_s2d3d": "26c6f3d931ea8d422cdce906b45abaa3bda3ddeb66f4f55714fee0dc51992c2d",
}
FLOPS = {  # a panorama's, at the cell's batch
    "oneshot_s2d3d.batched_b64": 71274230784.0,
    "iterative_s2d3d.batched_b64": 142587325440.0,
    "oneshot_s2d3d.train_b8": 212448411648.0,
}
BOUNDS = {  # seconds of a forward or a train step
    "oneshot_s2d3d.batched_b64": {"quad_blend": 0.00019725336358208956, "quad_spread": 0.0,
                                  "up2x": 0.000816950256716418, "up2x_adjoint": 0.0},
    "iterative_s2d3d.batched_b64": {"quad_blend": 0.0002107137050746269, "quad_spread": 0.0,
                                    "up2x": 0.001633900513432836, "up2x_adjoint": 0.0},
    "oneshot_s2d3d.train_b8": {"quad_blend": 4.554294925373134e-05,
                               "quad_spread": 2.2217528358208955e-05,
                               "up2x": 0.00019719488955223882,
                               "up2x_adjoint": 0.00019719488955223882},
}
CHECKS = {
    ("oneshot_s2d3d.batched_b64", 41): {"depth_gap": 1.392349372883689,
                                        "control.depth_gap": 10.477734742818662},
    ("iterative_s2d3d.batched_b64", 41): {"depth_gap": 1.3707139204973366,
                                          "control.depth_gap": 9.949940923917563},
    (TRAIN, 43): {
        "loss_gap": 2.594852315236052e-05, "grad_gap": 0.0028136256402720734,
        "change_gap": 0.04176709102771943, "grad_diff": 0.02955618052648045,
        "control.loss_gap": 0.0014111253316458424, "control.grad_gap": 0.146037483368298,
        "control.change_gap": 0.10981072820512111, "control.grad_diff": 3.03985049068934,
        "half_batch.loss_gap": 0.22076557071823558, "half_batch.grad_gap": 0.686350364055933,
        "half_batch.change_gap": 0.12853626634064805, "half_batch.grad_diff": 7.623319540779832,
    },
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("cell", SERVING)
def test_weights_bit_for_bit(cell):
    cfg = harness.load_cell(cell, overrides=overrides(cell)).config
    h = hashlib.sha256()
    for name, t in weights.make(cfg, 17, "cpu").items():
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == WEIGHTS[cfg["name"]]


@pytest.mark.parametrize("cell", list(FLOPS))
def test_flops_and_kernel_bounds_at_the_cells_shapes(cell):
    c = harness.load_cell(cell)
    train = c.traffic["mode"] == "train"
    assert yardstick.flops_per_panorama(c.config, c.traffic["batch"], train) == FLOPS[cell]
    assert yardstick.kernel_bounds(c.config, c.traffic["precision"], c.traffic["batch"],
                                   train) == BOUNDS[cell]


@pytest.mark.parametrize("cell, seed", list(CHECKS))
def test_check_values_of_one_seed(cell, seed, one_thread):
    c = harness.load_cell(cell, overrides=overrides(cell))
    read = calibrate.train_readings if cell == TRAIN else calibrate.serve_readings
    (row,) = read(c, [seed], "cpu")
    assert row.pop("seed") == seed
    assert row == pytest.approx(CHECKS[cell, seed], rel=1e-9)
