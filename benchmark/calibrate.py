"""Readings that a cell's limits are set from, for many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3

For each seed, with that seed's weights and inputs, at the cell's own
sizes: the program's numbers of the check, through the timed path's own
call (serving: every pass's output of one batch; training: the first three
steps of a fresh train state); the control's (serving: the reference
computed in the precision below the configuration's, ``check.CONTROL``,
put in the program's place; training: the program's own bf16 path, the
precision below TF32); and, for training, the fault of a half batch (the
reference on the first half of each batch). One JSON line per seed, then the largest program reading and
the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import check, generator, harness, program, weights  # noqa: E402
from benchmark.modes import train as train_mode  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402


def serve_readings(cell, seeds, device):
    cfg, tr = cell.config, cell.traffic
    kind = program.kind(cfg)
    name = ref.kind(cfg).SERVE_CHECK
    geom = ref.Geometry(cfg, device)
    for seed in seeds:
        state = weights.make(cfg, generator.stream_seed(seed, generator.WEIGHTS), device)
        model = kind.build(cfg, tr["precision"], state, device).eval()
        state = {k: v.cpu() for k, v in state.items()}
        rgb = generator.erp_pool(cfg, dict(tr, pool=1), seed, device)[0]
        with torch.inference_mode():
            pairs = [(rgb, kind.outputs(model(rgb)))]
        del model
        gaps = check.serve_gaps(cfg, state, pairs, device, tr["check_block"], [check.CONTROL], geom)
        yield {"seed": seed, name: max(gaps["program"]),
               f"control.{name}": max(gaps[repr(check.CONTROL)])}


def train_readings(cell, seeds, device):
    cfg, tr = cell.config, cell.traffic
    kind = program.kind(cfg)
    geom = ref.Geometry(cfg, device)
    steps = train_mode.COMPARED_STEPS
    for seed in seeds:
        state = weights.make(cfg, generator.stream_seed(seed, generator.WEIGHTS), device)
        model = kind.build(cfg, tr["precision"], state, device)
        state = {k: v.cpu() for k, v in state.items()}
        ts = program.train_state(model, tr)
        pool = generator.train_pool(cfg, dict(tr, pool=steps), seed, device)
        prog = train_mode.first_steps(kind, ts, pool, steps, state, device)
        del model, ts
        refr = check.reference_train(cfg, tr["recipe"], state, pool, device, geom=geom)
        unit = check.reference_unit(cfg, tr["recipe"], state, pool[:1], device, geom)
        row = {"seed": seed, **check.train_gaps(prog, refr, unit)}
        # the program's own bf16 path (cli/train.py --bf16) is the control
        model = kind.build(cfg, dict(tr["precision"], trunk="bf16"), state, device)
        ts = program.train_state(model, tr)
        ctrl = train_mode.first_steps(kind, ts, pool, steps, state, device)
        del model, ts
        row.update({f"control.{k}": v for k, v in check.train_gaps(ctrl, refr, unit).items()})
        half = [{k: v[: len(v) // 2] for k, v in b.items()} for b in pool]
        hb = check.reference_train(cfg, tr["recipe"], state, half, device, geom=geom)
        row.update({f"half_batch.{k}": v for k, v in check.train_gaps(hb, refr, unit).items()})
        yield row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.fix_cache_dirs()
    seeds = [int(s) for s in args.seeds.split(",")]
    read = train_readings if cell.traffic["mode"] == "train" else serve_readings
    rows = []
    for row in read(cell, seeds, "cuda"):
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {k: (min if k.startswith(("control.", "half_batch.")) else max)(r[k] for r in rows)
               for k in rows[0] if k != "seed"}
    print(json.dumps({"workload": cell.name, "seeds": len(rows), "program_max_control_min": summary}))


if __name__ == "__main__":
    main()
