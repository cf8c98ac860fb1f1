"""Readings that a cell's ``token_gap`` limit is set from, for many seeds in
one process (cells whose mix runs ``modes/serve_batched_tokens.py``).

    python3 benchmark/calibrate_tokens.py --workload <cell> --seeds 1,2,3

For each seed, with that seed's weights and inputs, at the cell's own
sizes: ``token_gap`` of one batch served through the timed path's own
call, and of each control of the mode (``CONTROLS``: the reference's
transformer with its products' operands rounded to TF32 and to bf16, put
in the program's place), and the program's gap from the reference's
transformer in float64 (``f64``: the scale of f32's own rounding, which a
sound f32 transformer reads about as much of). One JSON line per seed,
then the largest program reading and the smallest of each control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import check, generator, harness, program, weights  # noqa: E402
from benchmark.modes import serve_batched_tokens as mode  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402


def readings(cell, seeds, device):
    cfg, tr = cell.config, cell.traffic
    kind = program.kind(cfg)
    for seed in seeds:
        state = weights.make(cfg, generator.stream_seed(seed, generator.WEIGHTS), device)
        model = kind.build(cfg, tr["precision"], state, device).eval()
        state = {k: v.cpu() for k, v in state.items()}
        rgb = generator.erp_pool(cfg, dict(tr, pool=1), seed, device)[0]
        held = []
        with torch.inference_mode():
            hook = mode.holding(model, held)
            kind.outputs(model(rgb))
            hook.remove()
        del model
        gaps = mode.token_gaps(cfg, state, held, device, mode.CONTROLS)
        yield {"seed": seed, mode.CHECK: max(gaps["program"]),
               **{f"control.{c}": min(gaps[c]) for c in mode.CONTROLS},
               "f64": max(f64_gaps(cfg, state, held, device))}


def f64_gaps(cfg, state, held, device) -> list[float]:
    """Per panorama, the relative L2 gap of the tokens out from the
    reference's transformer run in float64 on the tokens in (the
    embedding added in their dtype, as ``mode.reference_tokens`` adds it)."""
    params = {k: v.to(device).double() for k, v in state.items() if k.startswith("transformer.")}
    pos = params["transformer.pos_emb"]
    p = dict(params, **{"transformer.pos_emb": torch.zeros_like(pos)})
    gaps = []
    with torch.inference_mode():
        for tok, out in held:
            tok = tok.to(device)
            x = (tok + pos.to(tok.dtype)).double()
            gaps += check.rel_l2(out.to(device), ref.transformer(p, cfg, x))
    return gaps


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
