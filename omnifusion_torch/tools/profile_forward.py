"""Device and host time of the flagship forward, or train step, by kernel and by span.

    python -m omnifusion_torch.tools.profile_forward --batch 64 --bf16 --merge_dtype f16 --host_reps 10
    python -m omnifusion_torch.tools.profile_forward --batch 8 --train --host_reps 10
    python -m omnifusion_torch.tools.profile_forward --device cpu --erp_size 64,128 --patchsize 32 --batch 1

The port's counterpart of ``tools/profile_forward.py``. It runs warm
forwards of the one-shot model, or of the iterative one with ``--model
iterative`` (seeded weights; ``--bf16``, ``--merge_dtype``), or with
``--train`` warm train steps (``training.train_step``, AdamW, BerHu on
synthetic targets), in these windows, each of them ended by one
synchronize:

- the warm-up: one forward or step, recorded; ``setup`` holds the seconds
  of its ``kernel_library`` and ``tables`` spans (the kernel library built
  or loaded, the tables computed or read from disk and moved to the
  device) and its counters;
- with ``--host_reps N``, four host windows of N each, spans off, on, on,
  off: ``host_window`` holds the ms a rep of each on the host clock, and
  the host table holds the spans' host time in the two with spans on, where
  no profiler runs;
- ``--reps`` under ``utils.profiling.trace`` with the spans recorded, in
  the Chrome trace as ``span:<name>`` ranges. A device op counts in every
  span range open on the stepping thread when the host call that launched
  it ran (the launch's correlation id; autograd's thread launches the
  backward, inside the stepping thread's ``backward``), and each gap in
  which the device idles is named by the innermost range open on the
  stepping thread when it began. Without ``--host_reps`` the host table is
  this window's, so it holds the profiler's cost too.

It prints device time by kernel name, by stage, by kernel within each
stage and by idle gap (the card only), host time by stage and the set-up
line, then one JSON line with all of them, the device's busy share of the
traced window and ``runs``, the forwards or steps it ran. The stages are
the program's spans (``utils/profiling.py``): for a forward the ``model``
span's children (e2p, points, encoder, transformer, decoder, heads, merge;
the iterative model opens them per pass), with ``--train`` the
``train_step`` span's (forward, loss, backward, optimizer; the gradient
norm falls in the optimizer); ``by_span`` holds every span's device time
and ``kernels_by_stage`` each stage's by kernel. On the CPU there are no
kernels: the tables hold the host time of each operator (self time) and of
each stage.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from omnifusion_torch.cli.common import MERGE_DTYPES, pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, train_step
from omnifusion_torch.utils.profiling import recording, trace

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_PREFIX = "cuda_"  # CUDA API calls; a launch carries its kernel's correlation id
_SPAN = "span:"
OUTSIDE = "outside the stages"
SETUP_SPANS = ("kernel_library", "tables")
MODELS = {"oneshot": SphericalFusion, "iterative": SphericalFusionIterative}


def split_trace(path: str, parent: str) -> dict:
    """Device ms by kernel name, by span (inclusive) and by idle gap from a
    Chrome trace, as the module docstring says; the stepping thread is the
    one whose ranges are ``span:<parent>``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(_SPAN)]
    tids = {e["tid"] for e in spans if e["name"] == _SPAN + parent}
    if not tids:
        raise RuntimeError(f"no span:{parent} in {path}")
    # (start, end, name) on the stepping thread; nested ranges start later
    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(_SPAN):])
                    for e in spans if e["tid"] in tids)

    def open_at(t):
        return [name for t0, t1, name in ranges if t0 <= t <= t1]

    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat", "").startswith(_LAUNCH_PREFIX) and "correlation" in e.get("args", {})}
    by_kernel = collections.defaultdict(float)
    by_span = collections.defaultdict(float)
    by_span_kernel = collections.defaultdict(lambda: collections.defaultdict(float))
    busy = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        ms = e.get("dur", 0) / 1e3
        by_kernel[e["name"]] += ms
        t = launch.get(e.get("args", {}).get("correlation"))
        for name in set(open_at(t)) if t is not None else ():
            by_span[name] += ms
            by_span_kernel[name][e["name"]] += ms
        busy.append((e["ts"], e["ts"] + e.get("dur", 0)))
    if not busy:
        return {"by_kernel": {}, "by_span": {}, "by_span_kernel": {}, "idle_by_span": {},
                "busy_ms": 0.0, "device_window_ms": 0.0}
    busy.sort()
    idle = collections.defaultdict(float)
    first, (start, end) = busy[0][0], busy[0]
    union = 0.0
    for t0, t1 in busy:
        if t0 > end:  # the device idles from ``end`` to ``t0``
            inner = open_at(end)
            idle[inner[-1] if inner else OUTSIDE] += (t0 - end) / 1e3
            union += end - start
            start = t0
        end = max(end, t1)
    union += end - start
    return {"by_kernel": dict(by_kernel), "by_span": dict(by_span),
            "by_span_kernel": {k: dict(v) for k, v in by_span_kernel.items()},
            "idle_by_span": dict(idle), "busy_ms": union / 1e3,
            "device_window_ms": (end - first) / 1e3}


def host_by_stage(spans, parent: str) -> dict:
    """Host ms of each child span of ``parent``, summed by name."""
    host = collections.defaultdict(float)
    for s in spans:
        if s.parent == parent:
            host[s.name] += (s.end_ns - s.start_ns) / 1e6
    return dict(host)


def table(title: str, rows: dict, reps: int, top: int) -> list[dict]:
    total = sum(rows.values())
    out = [{"name": k, "ms_per_rep": v / reps, "share": v / total if total else 0.0}
           for k, v in sorted(rows.items(), key=lambda kv: -kv[1])[:top]]
    print(f"\n== {title} ==  (total {total / reps:.3f} ms/rep)")
    print(f"{'ms/rep':>10s} {'share':>7s}  name")
    for r in out:
        print(f"{r['ms_per_rep']:10.3f} {100 * r['share']:6.1f}%  {r['name'][:100]}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="profile the flagship forward (PyTorch port)")
    ap.add_argument("--model", choices=sorted(MODELS), default="oneshot")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bf16", action="store_true", help="bf16 trunk")
    ap.add_argument("--merge_dtype", choices=sorted(MERGE_DTYPES), default="f32")
    ap.add_argument("--train", action="store_true", help="train steps, not forwards")
    ap.add_argument("--reps", type=int, default=3, help="forwards or steps traced")
    ap.add_argument("--host_reps", type=int, default=0,
                    help="forwards or steps in each of the four host windows (default: none)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--profile_dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def run(args) -> dict:
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    model = MODELS[args.model](spec, dtype=torch.bfloat16 if args.bf16 else None,
                               merge_dtype=MERGE_DTYPES[args.merge_dtype], device=device)
    init_weights(model, 0)
    rng = np.random.default_rng(0)
    shape = (args.batch, *args.erp_size)
    batches = [{
        "rgb": torch.from_numpy(rng.random((*shape, 3), dtype=np.float32)).to(device),
        "depth": torch.from_numpy(rng.random((*shape, 1), dtype=np.float32) * 7 + 0.3).to(device),
        "mask": torch.ones(*shape, 1, device=device),
    } for _ in range(args.reps)]

    if args.train:
        state = create_train_state(model)

        def step(b):
            return train_step(state, b)["loss"]

        parent = "train_step"
        grad = contextlib.nullcontext()
    else:
        model.eval()

        def step(b):
            out = model(b["rgb"])  # the iterative model's passes: the last
            return (out[-1] if isinstance(out, list) else out).float().sum()  # f16 would overflow

        parent = "model"
        grad = torch.inference_mode()

    def window(n: int) -> float:
        """``n`` forwards or steps over the batches in turn, ended by one
        synchronize (reading their sum); host ms."""
        t0 = time.perf_counter()
        total = float(sum(step(batches[i % len(batches)]) for i in range(n)))
        if not np.isfinite(total):
            raise RuntimeError(f"non-finite result while profiling: {total}")
        return (time.perf_counter() - t0) * 1e3

    prof_dir = args.profile_dir or tempfile.mkdtemp(prefix="profile_forward_")
    host_windows, host_spans = [], []
    with grad:
        with recording() as setup:
            window(1)  # warm-up: cuDNN's choices, the tables, the kernel library
        for spans_on in ((False, True, True, False) if args.host_reps else ()):
            with recording() if spans_on else contextlib.nullcontext() as rec:
                host_windows.append((spans_on, window(args.host_reps)))
            host_spans += rec.spans if spans_on else []
        with trace(prof_dir) as prof, recording() as rec:
            window(args.reps)
    what = "train step" if args.train else "forward"
    result = {"what": what, "model": args.model, "batch": args.batch,
              "dtype": "bf16" if args.bf16 else "f32", "merge_dtype": args.merge_dtype,
              "reps": args.reps, "host_reps": args.host_reps,
              "runs": args.reps + 4 * args.host_reps + 1,  # traced, host windows, warm-up
              "device": torch.cuda.get_device_name(device) if on_card else "cpu",
              "trace": os.path.join(prof_dir, "trace.json")}
    stages = host_by_stage(rec.spans, parent)
    if on_card:
        split = split_trace(result["trace"], parent)
        busy = sum(split["by_kernel"].values())
        if not busy:
            raise RuntimeError(f"the trace {result['trace']} holds no device time")
        by_stage = {k: v for k, v in split["by_span"].items() if k in stages}
        by_stage[OUTSIDE] = busy - sum(by_stage.values())
        result.update(
            top_kernels=table(f"device time by kernel, {what}", split["by_kernel"],
                              args.reps, args.top),
            stages=table(f"device time by stage, {what}", by_stage, args.reps, 99),
            idle=table(f"device idle by the innermost span open, {what}",
                       split["idle_by_span"], args.reps, 99),
            by_span={k: v / args.reps for k, v in split["by_span"].items()},
            kernels_by_stage={k: table(f"device time by kernel in {k}, {what}", v, args.reps,
                                       args.top)
                              for k, v in split["by_span_kernel"].items() if k in stages},
            device_ms_per_rep=busy / args.reps,
            device_busy_share=split["busy_ms"] / split["device_window_ms"],
        )
    else:
        ops = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
               if not e.key.startswith(_SPAN)}
        result.update(
            top_ops=table(f"host self time by operator, {what} (cpu)", ops, args.reps, args.top),
        )
    if host_windows:
        off = [ms for on, ms in host_windows if not on]
        on = [ms for on, ms in host_windows if on]
        result["host_window"] = {"ms_per_rep_spans_off": sum(off) / (2 * args.host_reps),
                                 "ms_per_rep_spans_on": sum(on) / (2 * args.host_reps),
                                 "windows_ms": [ms for _, ms in host_windows]}
        print(f"\n== host windows, spans off, on, on, off ==  {result['host_window']}")
        result["host_stages"] = table(f"host time by stage, {what} (spans on, no profiler)",
                                      host_by_stage(host_spans, parent), 2 * args.host_reps, 99)
    else:
        result["host_stages"] = table(f"host time by stage, {what} (under the profiler)",
                                      stages, args.reps, 99)
    seconds = setup.seconds()
    result["setup"] = {"seconds": {k: seconds[k] for k in SETUP_SPANS if k in seconds},
                       "counters": setup.counters}
    print(f"\n== set-up in the warm-up ==  {result['setup']}")
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
