"""A configuration of a new model kind joins the benchmark as new files and
entries only: in a copy of the benchmark, a stand-in kind (the one-shot
model under another name, with a check and merge rows of its own), its
configuration, a traffic mix with a mode of its own, the cell's limits
and its entries in ``BENCHMARK.json``; no other file of the copy changes,
and the copy's CPU dry run of the new cell passes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

NEW_FILES = {
    "benchmark/models/standin.py": '''"""Stand-in kind: the one-shot model under another name."""
from benchmark.models.oneshot import build, outputs, train_step  # noqa: F401
''',
    "benchmark/reference/standin.py": '''"""Stand-in kind: the one-shot reference, its own check and merge rows."""
from benchmark.reference.oneshot import (RECIPE, calibrate, forward, geometry,  # noqa: F401
                                         geometry_input, loss, param_specs, passes, targets)

SERVE_CHECK = "standin_gap"


def merge_rows(cfg):
    return 3
''',
    "benchmark/modes/serve_standin.py": '''"""Stand-in mode: batched serving with CPU test sizes of its own."""
from benchmark.modes.serve_batched import run  # noqa: F401

SMALL = {"batch": 1, "pool": 2, "check_among": 2, "check_count": 1, "trace_steps": 1,
         "warmup_rounds": 1}
''',
    "benchmark/workloads/standin_s2d3d.standin_b2.json": json.dumps(
        {"limits": {"standin_gap": 3.8}, "readings": {}}),
}
CELL = "standin_s2d3d.standin_b2"
DRIVE = """
import json, sys
from benchmark import harness, run, yardstick
from benchmark.tests.small import cli_args, overrides

def merge_bound(cell):
    c = harness.load_cell(cell, overrides=overrides(cell))
    return yardstick.kernel_bounds(c.config, c.traffic["precision"], 1, False)["quad_blend"]

rc = run.main(cli_args(sys.argv[1], trace=1))
print(json.dumps({"rc": rc, "standin": merge_bound(sys.argv[1]),
                  "oneshot": merge_bound("oneshot_s2d3d.batched_b64")}))
"""


def _tree(root):
    """sha256 of every file of the benchmark (BENCHMARK.json and benchmark/)."""
    paths = [os.path.join(root, "BENCHMARK.json")]
    for d, dirs, files in os.walk(os.path.join(root, "benchmark")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        paths += [os.path.join(d, f) for f in files]
    out = {}
    for path in paths:
        with open(path, "rb") as f:
            out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _add_the_kind(root):
    for rel, text in NEW_FILES.items():
        with open(os.path.join(root, rel), "w") as f:
            f.write(text)
    cfg = harness.load_json(os.path.join(root, "benchmark/configs/oneshot_s2d3d.json"))
    cfg.update(name="standin_s2d3d", model="standin")
    mix = harness.load_json(os.path.join(root, "benchmark/traffic/batched_b64.json"))
    mix.update(mode="serve_standin", batch=2)
    for rel, data in (("benchmark/configs/standin_s2d3d.json", cfg),
                      ("benchmark/traffic/standin_b2.json", mix)):
        with open(os.path.join(root, rel), "w") as f:
            json.dump(data, f)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": "standin_s2d3d", "source": "https://example.org/standin",
                             "file": "benchmark/configs/standin_s2d3d.json", "reduced": [],
                             "why": "a stand-in kind"})
    bench["workloads"].append({"name": CELL, "config": "standin_s2d3d", "traffic": "standin_b2",
                               "chips": 1, "why": "a stand-in cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("serve_panos_per_s", "mfu.batched"):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=2)


def test_a_new_kind_joins_with_new_files_and_entries_only(tmp_path):
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(harness.HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(root)
    _add_the_kind(root)
    path = os.pathsep.join(filter(None, [harness.ROOT, os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=path)
    proc = subprocess.run([sys.executable, "-c", DRIVE, CELL], cwd=root, capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    *_, line, bounds = proc.stdout.strip().splitlines()
    line, bounds = json.loads(line), json.loads(bounds)
    assert bounds["rc"] == 0 and line["correct"] is True and line["attempted"] > 0
    assert list(line["checks"]) == ["standin_gap"]
    assert bounds["standin"] > bounds["oneshot"]  # three merge rows a panorama, not two
    after = _tree(root)
    assert {k for k in after if before.get(k) != after[k]} == {
        "BENCHMARK.json", "benchmark/configs/standin_s2d3d.json",
        "benchmark/traffic/standin_b2.json", *NEW_FILES}
    assert set(before) <= set(after)
