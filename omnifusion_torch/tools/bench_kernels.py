"""Times of quad_spread and up2x at the main paths' shapes, one JSON line.

    python -m omnifusion_torch.tools.bench_kernels
    PYTHONPATH=other_checkout python omnifusion_torch/tools/bench_kernels.py
    python -m omnifusion_torch.tools.bench_kernels --device cpu --erp_size 64,128 --patchsize 32

At the flagship config (512x1024 ERP, patch 128, fov 80, nrows 4):
quad_spread at the merge's backward (f32 cotangent, ``--train_batch``
panoramas) and up2x summed over the decoder's five upsamples (``--batch``
panoramas), in f32 and in the bf16 recipe (the first upsample f32, the rest
bf16), each beside its bound. It uses only entry points that every version
of the port has had since its bf16 recipe, so run as a file with another
checkout first on PYTHONPATH it times that checkout's kernels: two versions
compared in one call on one card. Device ms from CUDA events on the card,
host ms on the CPU (``timed_on``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

import omnifusion_torch
from omnifusion_torch.cli.infer import pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.ops.quad_blend import quad_spread
from omnifusion_torch.ops.upsample import up2x
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import pers2equi_tables
from omnifusion_torch.utils.profiling import bound_ms, gpu_line, nbytes, time_ms

# the decoder's upsamples: (channels, input side / patch side); the
# flagship's patch 128 gives sides 4, 8, 16, 32, 64
DECODER = ((512, 1 / 32), (128, 1 / 16), (64, 1 / 8), (64, 1 / 4), (32, 1 / 2))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="quad_spread and up2x times (PyTorch port)")
    ap.add_argument("--batch", type=int, default=2, help="panoramas per forward (up2x)")
    ap.add_argument("--train_batch", type=int, default=8, help="panoramas per step (quad_spread)")
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def run(args) -> dict:
    device = resolve_device(args.device)
    timer = lambda fn: time_ms(fn, device, iters=args.iters, warmup=3)  # noqa: E731
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    rng = np.random.default_rng(0)
    t = pers2equi_tables(spec, device).vjp
    cot = torch.from_numpy(rng.random((args.train_batch, 2, t.n_out), dtype=np.float32)).to(device)
    spread = {"shape": list(cot.shape), "ms": timer(lambda: quad_spread(cot, t))}

    ups = {}
    for recipe in ("f32", "bf16"):
        rows = []
        for i, (c, frac) in enumerate(DECODER):
            side = max(1, int(spec.patch_h * frac))
            x = torch.from_numpy(
                rng.random((args.batch * spec.n_patches, c, side, side), dtype=np.float32)
            ).to(device)
            if recipe == "bf16" and i > 0:
                x = x.bfloat16()
            b_ms, _ = bound_ms(5 * nbytes(x), 9.0 * 4 * x.numel())
            rows.append({"shape": list(x.shape), "dtype": str(x.dtype)[6:],
                         "ms": timer(lambda: up2x(x)), "bound_ms": b_ms})
        ups[recipe] = {"ms": sum(r["ms"] for r in rows),
                       "bound_ms": sum(r["bound_ms"] for r in rows), "shapes": rows}
    return {
        "port": os.path.dirname(os.path.abspath(omnifusion_torch.__file__)),
        "gpu": gpu_line() if device.type == "cuda" else None,
        "timed_on": "cuda events" if device.type == "cuda" else "cpu host clock",
        "quad_spread": spread, "up2x": ups,
    }


def main(argv=None) -> None:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
