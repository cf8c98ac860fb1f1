"""Readings that a cell's ``merge_gap`` limit is set from, for many seeds in
one process (cells whose mix runs ``modes/serve_batched_merge.py``).

    python3 benchmark/calibrate_merge.py --workload <cell> --seeds 1,2,3

For each seed, with that seed's weights and inputs, at the cell's own
sizes: ``merge_gap`` of one batch served through the timed path's own
call, and of each control of the mode (``CONTROLS``: the reference's merge
with its source rounded to f16 and to bf16, put in the program's place).
One JSON line per seed, then the largest program reading and the smallest
of each control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import generator, harness, program, weights  # noqa: E402
from benchmark.modes import serve_batched_merge as mode  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402


def readings(cell, seeds, device):
    cfg, tr = cell.config, cell.traffic
    kind = program.kind(cfg)
    geom = ref.Geometry(cfg, device)
    for seed in seeds:
        state = weights.make(cfg, generator.stream_seed(seed, generator.WEIGHTS), device)
        model = kind.build(cfg, tr["precision"], state, device).eval()
        del state
        rgb = generator.erp_pool(cfg, dict(tr, pool=1), seed, device)[0]
        heads = []
        with torch.inference_mode():
            model.gather_heads = mode.holding(model, heads)
            served = kind.outputs(model(rgb))[-1]
        del model
        gaps = mode.merge_gaps(cfg, [(*heads[0], served)], device, tr["check_block"],
                               mode.CONTROLS, geom)
        yield {"seed": seed, mode.CHECK: max(gaps["program"]),
               **{f"control.{c.merge}": min(gaps[repr(c)]) for c in mode.CONTROLS}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.fix_cache_dirs()
    rows = []
    for row in readings(cell, [int(s) for s in args.seeds.split(",")], args.device):
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    summary = {k: (min if k.startswith("control.") else max)(r[k] for r in rows)
               for k in rows[0] if k != "seed"}
    print(json.dumps({"workload": cell.name, "seeds": len(rows), "program_max_control_min": summary}))


if __name__ == "__main__":
    main()
