"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its weights and inputs from
``--seed``, warms up every shape it uses (set-up, ``setup_s``), measures
for ``--seconds`` seconds, checks the window's answers against the plain
reference, and prints one JSON object as the last line of standard output
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, read from a traced window after the measured one) and
each compared number beside its limit as the last lines of standard error.
It exits non-zero and prints no result without the CUDA cards the cell
asks for, or when JAX or the JAX package is loaded once the window has
closed.

``--device cpu`` (tests only) runs the cell on the CPU with ``--override
key=value`` sizes and fills in no device metric.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = _ROOT  # the checkout's root, not benchmark/
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--override", action="append", default=[],
                    help="key=json value replacing a key of the configuration or the mix")
    return ap.parse_args(argv)


def main(argv=None, t_start: float = T_START) -> int:
    args = parse(argv)
    overrides = {k: json.loads(v) for k, v in (o.split("=", 1) for o in args.override)}
    cell = harness.load_cell(args.workload, overrides=overrides)
    harness.fix_cache_dirs()
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        torch.cuda.set_device(0)
    mode = harness.mode_module(cell.traffic["mode"])
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace), args.device, t_start)
    out = mode.run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"modules the benchmark may not load are loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    line = harness.result_line(cell, out, bool(args.trace), args.device)
    phases = {"setup": out.e2e["setup_s"], **out.facts.get("phase_s", {})}
    print("seconds " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    stages, last = [], t_start
    for stage, t in ctx.marks:
        stages.append(f"{stage} {t - last:.3f}")
        last = t
    print("set-up seconds " + " ".join(stages), file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
