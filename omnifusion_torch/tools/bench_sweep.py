"""Forward throughput of the flagship over batches and precision modes, with
MFU; prints a line per (batch, mode), then one JSON line.

    python -m omnifusion_torch.tools.bench_sweep                  # batches 32,64,96
    python -m omnifusion_torch.tools.bench_sweep --batches 8,64 --modes f32,f16_merge
    python -m omnifusion_torch.tools.bench_sweep --model iterative
    python -m omnifusion_torch.tools.bench_sweep --device cpu --erp_size 64,128 --patchsize 32 --batches 1,2

The port's counterpart of ``tools/bench_sweep.py``: the flagship model
(512x1024 ERP, patch 128, fov 80, nrows 4; ``--model iterative``: 2 passes,
the last one's depth) from seeded weights (``init_weights(model, 0)``), in
each mode of ``--modes``: ``f32`` (TF32 as cuDNN allows), ``bf16`` (bf16
trunk, f32 merge), ``bf16_merge`` and ``f16_merge`` (bf16 trunk with a bf16
or f16 merge: the serving recipe is ``f16_merge``). Each row times
``--iters`` forwards of one seeded batch as ``bench.py`` does, their device
time (CUDA events, ``utils.profiling.time_ms``) and their wall time, ended
by a synchronize, beside the forward's FLOPs counted from shapes
(``utils.profiling.count_flops``, on the first forward) and their MFU
against the dense peak of the trunk's precision; ``forwards`` counts every
forward the run made. On the CPU the times are the host's and no MFU is
given.

Not ported: ``--kernel_impl`` (the port has one implementation of the
blend, its CUDA kernel).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omnifusion_torch.cli.common import pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.utils.profiling import (
    count_flops, device_and_wall_ms, gpu_line, mfu, trunk_precision,
)

# (trunk dtype, merge dtype) of each mode
MODES = {
    "f32": (None, None),
    "bf16": (torch.bfloat16, None),
    "bf16_merge": (torch.bfloat16, torch.bfloat16),
    "f16_merge": (torch.bfloat16, torch.float16),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="forward throughput sweep (PyTorch port)")
    ap.add_argument("--batches", default="32,64,96")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--modes", default="bf16,f16_merge",
                    help=f"comma-separated, of {','.join(MODES)}")
    ap.add_argument("--model", default="oneshot", choices=("oneshot", "iterative"))
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def run(args) -> dict:
    device = resolve_device(args.device)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise SystemExit(f"--modes: unknown {unknown}; options: {sorted(MODES)}")
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    models = {}
    for mode in modes:
        dtype, merge = MODES[mode]
        kw = dict(dtype=dtype, merge_dtype=merge, device=device)
        m = (SphericalFusionIterative(spec, num_iters=2, **kw) if args.model == "iterative"
             else SphericalFusion(spec, **kw))
        models[mode] = init_weights(m, 0).eval()
    rows, lines, forwards = [], [], 0
    for b in (int(x) for x in args.batches.split(",")):
        x = torch.from_numpy(
            np.random.default_rng(0).random((b, *args.erp_size, 3), dtype=np.float32)
        ).to(device)
        for mode in modes:
            model = models[mode]

            def forward():
                nonlocal forwards
                forwards += 1
                out = model(x)
                return out[-1] if isinstance(out, list) else out

            with torch.no_grad():
                flops = count_flops(forward)["total"]
            with torch.inference_mode():
                t = device_and_wall_ms(forward, device, args.iters)
            if not torch.isfinite(t["last"]).all():
                raise RuntimeError(f"bench_sweep b={b} {mode}: non-finite depth")
            precision = trunk_precision(MODES[mode][0])
            ms = t["device_ms"]
            row = {"batch": b, "mode": mode, "device_ms": ms, "wall_ms": t["wall_ms"],
                   "panos_per_s": b / (t["wall_ms"] / 1e3), "gflop": flops / 1e9,
                   "precision": precision,
                   "mfu": mfu(flops, ms, precision) if ms is not None else None}
            rows.append(row)
            line = (f"b={b:3d} {mode:10s} {ms if ms is not None else t['wall_ms']:8.2f} ms "
                    f"({'device' if ms is not None else 'cpu host'}, wall {t['wall_ms']:.2f})  "
                    f"{row['panos_per_s']:8.1f} panos/s  {flops / 1e9:.1f} GFLOP")
            if row["mfu"] is not None:
                line += f"  MFU {row['mfu'] * 100:.2f}% of {precision}"
            lines.append(line)
        del x
    return {"tool": "bench_sweep", "model": args.model, "erp": list(args.erp_size),
            "patch": list(args.patchsize), "iters": args.iters, "rows": rows,
            "forwards": forwards,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "gpu": gpu_line() if device.type == "cuda" else None, "lines": lines}


def main(argv=None) -> None:
    out = run(build_parser().parse_args(argv))
    for line in out.pop("lines"):
        print(line, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
