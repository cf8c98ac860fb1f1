"""A ``--device cpu`` run of each cell prints the result line last, with
no device metric filled in, and the compared numbers beside their limits."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.small import CELLS, cli_args


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_dry_run_prints_the_last_line(cell, trace):
    env = dict(os.environ, OMP_NUM_THREADS="4")
    proc = subprocess.run([sys.executable, "benchmark/run.py", *cli_args(cell, trace=trace)],
                          cwd=harness.ROOT, capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert "breakdown" not in line
    last = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [s.split()[1] for s in last] == list(line["checks"])


def test_a_run_without_a_card_exits_without_a_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
