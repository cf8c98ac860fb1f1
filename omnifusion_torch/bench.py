"""Serving throughput of the one-shot forward, as one JSON line.

    python -m omnifusion_torch.bench                  # batch 256 on the card
    python -m omnifusion_torch.bench --batch 8 --iters 10
    python -m omnifusion_torch.bench --device cpu --erp_size 64,128 --patchsize 32 --batch 1

The port's counterpart of the root ``bench.py``'s ``worker()``: the flagship
model (512x1024 ERP, patch 128, fov 80, nrows 4, ResNet-34 and the 6-layer
transformer) with the headline recipe, a bf16 trunk and an f16 merge,
seeded weights (``init_weights(model, 0)``), one seeded input batch on the
device. After two warm-up forwards it times ``--iters`` forwards twice: their device time
(``utils.profiling.time_ms``: CUDA events, the launches queued behind a
device-side sleep, so the host's launch rate is not in it), and their wall
time from a host clock that stops at a synchronize. ``value`` = batch /
wall seconds per forward, what a caller gets; where ``device_ms`` is much
below ``wall_ms`` the host limits the throughput.

Prints exactly one JSON line: metric, value (panoramas/s), unit, batch,
dtype, merge_dtype, gpu (name and power limit as nvidia-smi gives them),
device, device_ms, wall_ms, and forwards (every forward the run made, the
warm-up included). Any failure raises and exits non-zero. With
``--device cpu`` the value is the CPU's: ``gpu`` and ``device_ms`` are null.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from omnifusion_torch.cli.common import pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.utils.profiling import gpu_line, time_ms


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="one-shot forward throughput (PyTorch port)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def run(args) -> dict:
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    model = SphericalFusion(spec, dtype=torch.bfloat16, merge_dtype=torch.float16, device=device)
    init_weights(model, 0).eval()
    x = torch.from_numpy(
        np.random.default_rng(0).random((args.batch, *args.erp_size, 3), dtype=np.float32)
    ).to(device)
    forwards = 0

    def forward():
        nonlocal forwards
        forwards += 1
        return model(x)

    with torch.inference_mode():
        if on_card:
            device_ms = time_ms(forward, device, args.iters, warmup=2)
        else:
            device_ms = None
            for _ in range(2):
                forward()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = forward()
        if on_card:
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    if not torch.isfinite(out).all():
        raise RuntimeError("the forward produced non-finite depth")
    h, w = args.erp_size
    return {
        "metric": f"panoramas/sec ({h}x{w} ERP, patch {args.patchsize[0]}, fov 80, nrows 4, "
                  f"one-shot, batch {args.batch}, bf16 trunk + f16 merge)",
        "value": args.batch / (wall_ms / 1e3),
        "unit": "panoramas/sec",
        "batch": args.batch,
        "dtype": "bf16",
        "merge_dtype": "f16",
        "gpu": gpu_line() if on_card else None,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "device_ms": device_ms,
        "wall_ms": wall_ms,
        "forwards": forwards,
    }


def main(argv=None) -> None:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
