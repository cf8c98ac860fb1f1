"""Small sizes for the benchmark's CPU tests: every cell at 64x128 with
patch 32 and a short window, on the CPU, with its mode's own sizes
(``SMALL`` of ``benchmark/modes/<mode>.py``)."""

from __future__ import annotations

import json

from benchmark import harness

CELLS = [w["name"] for w in harness.load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]]
SIZES = {"erp_size": [64, 128], "patch_size": [32, 32]}


def overrides(cell: str) -> dict:
    mode = harness.load_cell(cell).traffic["mode"]
    return {**SIZES, **harness.mode_module(mode).SMALL}


def cli_args(cell: str, seed: int = 5, trace: int = 0, seconds: float = 0.5) -> list[str]:
    args = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--device", "cpu"]
    for k, v in overrides(cell).items():
        args += ["--override", f"{k}={json.dumps(v)}"]
    return args
