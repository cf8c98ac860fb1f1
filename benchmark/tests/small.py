"""Small sizes for the benchmark's CPU tests: every cell at 64x128 with
patch 32 and a short window, on the CPU."""

from __future__ import annotations

import json

from benchmark import harness

CELLS = [w["name"] for w in harness.load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]]
SIZES = {"erp_size": [64, 128], "patch_size": [32, 32]}
BY_MODE = {
    "serve_batched": {"batch": 2, "pool": 2, "check_among": 2, "check_count": 1,
                      "trace_steps": 1, "warmup_rounds": 1},
    "train": {"batch": 2, "pool": 3, "first_steps": 3, "trace_steps": 1},
}


def overrides(cell: str) -> dict:
    mode = harness.load_cell(cell).traffic["mode"]
    return {**SIZES, **BY_MODE[mode]}


def cli_args(cell: str, seed: int = 5, trace: int = 0, seconds: float = 0.5) -> list[str]:
    args = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--device", "cpu"]
    for k, v in overrides(cell).items():
        args += ["--override", f"{k}={json.dumps(v)}"]
    return args
