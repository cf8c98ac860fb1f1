"""The flagship train step and forward on the card, with their MFU; prints
a line each, then one JSON line.

    python -m omnifusion_torch.tools.bench_train                 # b8 f32 (TF32 as cuDNN allows)
    python -m omnifusion_torch.tools.bench_train --bf16 --merge_dtype f16
    python -m omnifusion_torch.tools.bench_train --model iterative --remat
    python -m omnifusion_torch.tools.bench_train --device cpu --erp 64,128 --patch 32,32 --iters 1

The port's counterpart of ``tools/bench_train.py``: the train config of the
reference (512x1024 ERP, fov 80, nrows 4, patch 128; BerHu, the mean over
the passes for ``--model iterative``, which merges without the confidence
as ``cli/train.py`` does; AdamW), seeded weights. The step is the trainer's
``train_step`` on one ``TrainState`` threaded through every step, on one
batch that stays on the device: what ``cli/train.py`` keeps live, as the
JAX tool's donated chain does. One step counts the FLOPs, one more warms,
then ``--iters`` steps are timed on the device (CUDA events,
``utils.profiling.time_ms``) and ``--iters`` more on the wall clock, ended
by reading the loss. The forward (eval mode, no gradients) is timed the
same way first, unless ``--skip_fwd``; ``--fwd_only`` builds no train
state.

Each line gives ms, panoramas/s, GFLOP and MFU (``calls`` in the JSON line
counts every forward or step the run made): the FLOPs counted from
shapes over the call (``utils.profiling.count_flops``: forward, or forward
and backward; with ``--remat`` the count runs one step without it, so the
recompute is not in the model FLOPs, and ``gflop_executed`` counts it)
over the device time, against the dense peak of the precision the trunk
runs in (f32 with TF32 off, TF32, or bf16 with ``--bf16``); and
``torch.cuda.max_memory_allocated`` over the timed steps, which ``--remat``
lowers. On the CPU the times are the host's and no MFU is given.

A card that runs out of memory prints the JAX tool's one line, ``OOM
needed=... limit=... <tag>``, and the tool exits 0: a batch that does not
fit is a measurement too.

Not ported, each for its reason: ``--kernel_impl`` and ``--resize_impl``
(the port has one implementation of each, its CUDA kernels) and
``--compile_only`` (it warms the XLA compile cache; the port compiles
nothing per shape).
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

from omnifusion_torch.cli.common import MERGE_DTYPES, pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, train_step
from omnifusion_torch.utils.profiling import (
    count_flops, device_and_wall_ms, gpu_line, mfu, trunk_precision,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="train step and forward with MFU (PyTorch port)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--bf16", action="store_true", help="bf16 trunk on f32 parameters")
    ap.add_argument("--merge_dtype", choices=sorted(MERGE_DTYPES), default="f32")
    ap.add_argument("--model", choices=["oneshot", "iterative"], default="oneshot")
    ap.add_argument("--erp", type=pair_arg, default=(512, 1024), help="ERP H,W")
    ap.add_argument("--patch", type=pair_arg, default=(128, 128))
    ap.add_argument("--nrows", type=int, default=4)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize the encoder: trades FLOPs for memory")
    ap.add_argument("--skip_fwd", action="store_true", help="time the train step alone")
    ap.add_argument("--fwd_only", action="store_true", help="time the forward alone")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def oom_line(e: BaseException, tag: str) -> str:
    """The one line of an out-of-memory run: what the failed allocation
    asked for and the card's capacity, from torch's message."""
    msg = str(e)
    need = re.search(r"Tried to allocate ([\d.]+ [KMGTP]?i?B)", msg)
    limit = re.search(r"total capacity of ([\d.]+ [KMGTP]?i?B)", msg)
    return (f"OOM needed={need.group(1).replace(' ', '') if need else '?'} "
            f"limit={limit.group(1).replace(' ', '') if limit else '?'} {tag}")


def batch_of(b: int, erp, device, seed: int = 100) -> dict:
    """rgb, depth and mask of ``b`` random panoramas (the JAX tool's
    ``batch_of``), on ``device``."""
    r = np.random.default_rng(seed)
    rgb = r.random((b, *erp, 3), dtype=np.float32)
    depth = (r.random((b, *erp, 1)) * 7 + 0.3).astype(np.float32)
    return {"rgb": torch.from_numpy(rgb).to(device), "depth": torch.from_numpy(depth).to(device),
            "mask": torch.ones(b, *erp, 1, device=device)}


def _rates(b: int, flops: int, times: dict, precision: str) -> dict:
    ms = times["device_ms"]
    return {"device_ms": ms, "wall_ms": times["wall_ms"], "panos_per_s": b / (times["wall_ms"] / 1e3),
            "gflop": flops / 1e9, "mfu": mfu(flops, ms, precision) if ms is not None else None}


def run(args) -> dict:
    device = resolve_device(args.device)
    b = args.batch
    tag = (f"batch={b} model={args.model} remat={args.remat} bf16={args.bf16} "
           f"merge={args.merge_dtype} erp={args.erp[0]}x{args.erp[1]}")
    dtype = torch.bfloat16 if args.bf16 else None
    out = {"tool": "bench_train", "batch": b, "model": args.model, "remat": args.remat,
           "bf16": args.bf16, "merge_dtype": args.merge_dtype, "erp": list(args.erp),
           "patch": list(args.patch), "nrows": args.nrows, "iters": args.iters,
           "precision": trunk_precision(dtype), "oom": None, "forward": None, "train": None,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "gpu": gpu_line() if device.type == "cuda" else None, "lines": []}
    phase = "build"
    try:
        spec = ProjectionSpec.create(args.erp, args.patch, (80.0, 80.0), args.nrows)
        kw = dict(dtype=dtype, merge_dtype=MERGE_DTYPES[args.merge_dtype], remat=args.remat,
                  device=device)
        model = (SphericalFusionIterative(spec, num_iters=2, **kw) if args.model == "iterative"
                 else SphericalFusion(spec, **kw))
        init_weights(model, 0)
        confidence = args.model == "oneshot"
        out["params"] = sum(p.numel() for p in model.parameters())
        out["lines"].append(f"params: {out['params'] / 1e6:.1f}M  ({tag})")
        batch = batch_of(b, args.erp, device)

        calls = {"forward": 0, "train": 0}  # every call the run makes

        def forward():
            calls["forward"] += 1
            return model(batch["rgb"])

        if not args.skip_fwd:
            phase = "fwd"
            model.eval()
            with torch.no_grad():
                flops = count_flops(forward)
            with torch.inference_mode():
                t = device_and_wall_ms(forward, device, args.iters)
            out["forward"] = {**_rates(b, flops["total"], t, out["precision"]),
                              "flops_by_op": flops["by_op"], "calls": calls["forward"]}
            out["lines"].append(_line("forward", b, out["forward"], out["precision"], tag))
        if args.fwd_only:
            return out

        phase = "train"
        state = create_train_state(model)

        def step():
            calls["train"] += 1
            return train_step(state, batch, confidence)

        model.remat = False  # the model's FLOPs: no recompute
        flops = count_flops(step)
        model.remat = args.remat
        executed = count_flops(step)["total"] if args.remat else flops["total"]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t = device_and_wall_ms(step, device, args.iters)
        loss = float(t["last"]["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"bench_train: the step's loss is {loss}")
        out["train"] = {**_rates(b, flops["total"], t, out["precision"]),
                        "gflop_executed": executed / 1e9, "loss": loss,
                        "flops_by_op": flops["by_op"], "calls": calls["train"],
                        "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                                       if device.type == "cuda" else None)}
        out["lines"].append(_line("train", b, out["train"], out["precision"], tag))
        return out
    except torch.cuda.OutOfMemoryError as e:
        out["oom"] = oom_line(e, f"{tag} phase={phase}")
        out["lines"].append(out["oom"])
        return out


def _line(what: str, b: int, r: dict, precision: str, tag: str) -> str:
    ms = r["device_ms"] if r["device_ms"] is not None else r["wall_ms"]
    where = "device" if r["device_ms"] is not None else "cpu host"
    s = (f"{what:8s} b={b}: {ms:8.2f} ms ({where}, wall {r['wall_ms']:.2f})  "
         f"{r['panos_per_s']:7.1f} panos/s  {r['gflop']:.1f} GFLOP")
    if r["mfu"] is not None:
        s += f"  MFU {r['mfu'] * 100:.2f}% of {precision}"
    if "loss" in r:
        s += f"  loss {r['loss']:.4f}"
    if r.get("max_memory_allocated_bytes") is not None:
        s += f"  peak {r['max_memory_allocated_bytes'] / 1e9:.2f} GB"
    return f"{s}  ({tag})"


def main(argv=None) -> None:
    out = run(build_parser().parse_args(argv))
    for line in out.pop("lines"):
        print(line, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
