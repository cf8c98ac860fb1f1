"""Time of each stage of the one-shot forward, one JSON line each.

    python -m omnifusion_torch.tools.bench_components --batch 64 --bf16 --merge_dtype f16
    python -m omnifusion_torch.tools.bench_components --only e2p,merge
    python -m omnifusion_torch.tools.bench_components --device cpu --erp_size 64,128 --patchsize 32 --batch 1

The port's counterpart of ``tools/bench_components.py``: at the flagship
config (512x1024 ERP, patch 128, fov 80, nrows 4), with seeded weights,
the equi2pers projection of a batch (in the trunk's dtype), the confidence
merge (in ``--merge_dtype``), the trunk (ResNet-34 encoder, transformer,
decoder, heads; the geometric point features computed once outside the
timing) and the full forward. Each is timed with CUDA events over
``--reps`` calls after a warm-up (device ms) on the card, and with the
host clock on the CPU. Each line holds component, ms, panoramas/s, batch,
dtype, merge_dtype and ``timed_on`` ("cuda events" or "cpu host clock").
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omnifusion_torch.cli.common import MERGE_DTYPES, pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, confidence_merge, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers
from omnifusion_torch.projection.spec import build_equi2pers_grids, build_pers2equi_grids
from omnifusion_torch.utils.profiling import time_ms

COMPONENTS = ("e2p", "merge", "trunk", "full")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="per-component times (PyTorch port)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--bf16", action="store_true", help="bf16 trunk and equi2pers")
    ap.add_argument("--merge_dtype", choices=sorted(MERGE_DTYPES), default="f32")
    ap.add_argument("--only", default="all", help=f"comma list of {','.join(COMPONENTS)}")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def run(args) -> list[dict]:
    only = COMPONENTS if args.only == "all" else tuple(args.only.split(","))
    if not set(only) <= set(COMPONENTS):
        raise ValueError(f"--only takes {COMPONENTS}, got {args.only!r}")
    device = resolve_device(args.device)
    cdt = torch.bfloat16 if args.bf16 else None
    mdt = MERGE_DTYPES[args.merge_dtype]
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    b, p, h, w = args.batch, spec.n_patches, spec.patch_h, spec.patch_w
    model = init_weights(SphericalFusion(spec, dtype=cdt, merge_dtype=mdt, device=device), 0).eval()
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.random((b, *args.erp_size, 3), dtype=np.float32)).to(device)
    e2p_grids, p2e_grids = build_equi2pers_grids(spec), build_pers2equi_grids(spec)

    with torch.inference_mode():
        erp = rgb.to(cdt) if cdt is not None else rgb
        pred = torch.from_numpy(rng.random((b, p, h, w), dtype=np.float32) * 8).to(device)
        conf = pred / 16 + 0.2
        patches = equi2pers(rgb, e2p_grids).permute(0, 1, 4, 2, 3).reshape(b * p, 3, h, w)
        point_feat = model.mlp_points(model.geo)
        bodies = {
            "e2p": lambda: equi2pers(erp, e2p_grids),
            "merge": lambda: confidence_merge(pred, conf, p2e_grids, dtype=mdt),
            "trunk": lambda: model.trunk(patches, point_feat, b),
            "full": lambda: model(rgb),
        }
        out = []
        for name in only:
            ms = time_ms(bodies[name], device, iters=args.reps, warmup=1)
            out.append({
                "component": name, "ms": ms, "panos_per_s": b / (ms / 1e3), "batch": b,
                "dtype": "bf16" if args.bf16 else "f32", "merge_dtype": args.merge_dtype,
                "timed_on": "cuda events" if device.type == "cuda" else "cpu host clock",
            })
    return out


def main(argv=None) -> None:
    for line in run(build_parser().parse_args(argv)):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
