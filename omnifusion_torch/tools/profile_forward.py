"""Device time of the flagship forward, or train step, by kernel and by stage.

    python -m omnifusion_torch.tools.profile_forward --batch 8 --bf16 --merge_dtype f16
    python -m omnifusion_torch.tools.profile_forward --batch 8 --train
    python -m omnifusion_torch.tools.profile_forward --device cpu --erp_size 64,128 --patchsize 32 --batch 1

The port's counterpart of ``tools/profile_forward.py``. It traces ``--reps``
warm forwards of the one-shot model (seeded weights; ``--bf16``,
``--merge_dtype``), or with ``--train`` warm train steps
(``training.train_step``, AdamW, BerHu on synthetic targets), under
``utils.profiling.trace``, then prints two tables: device time by kernel
name, and device time by stage, each with its share, and last one JSON
line with both, the device's busy share of the traced window and ``runs``,
the forwards or steps it ran (the reps and one warm-up).

Stages come from marks that this tool sets with hooks of its own; the
model's modules hold no profiling code. A mark is an empty
``record_function`` range named ``stage:<name>``, and a kernel belongs to
the last mark before the host call that launched it (the launch's
correlation id in the Chrome trace). Forward: e2p (the model's pre-hook),
points (``mlp_points``), encoder (``conv1``), transformer (``down``),
decoder (after the transformer or ``up_proj``), heads (after
``de_conv4_0``), merge (``confidence_merge``, wrapped for the run).
``--train``: forward, loss (the model's output hook), backward (a hook on
the output's gradient; the gradient norm falls in it), optimizer (the
optimizer's step pre-hook). On the CPU there are no kernels: the tables
hold the host time of each operator (self time) and of each stage.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import tempfile

import numpy as np
import torch
from torch.profiler import record_function

import omnifusion_torch.models.spherical_fusion as sf
from omnifusion_torch.cli.infer import MERGE_DTYPES, pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, train_step
from omnifusion_torch.utils.profiling import trace

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_PREFIX = "cuda_"  # CUDA API calls; a launch carries its kernel's correlation id


def mark(name: str) -> None:
    with record_function(f"stage:{name}"):
        pass


@contextlib.contextmanager
def stage_marks(model: SphericalFusion, optimizer=None):
    """Install the stage marks of the module docstring for the duration."""
    handles = []

    def pre(module, name):
        handles.append(module.register_forward_pre_hook(lambda *_: mark(name)))

    def post(module, name):
        handles.append(module.register_forward_hook(lambda *_: mark(name)))

    saved = sf.confidence_merge
    if optimizer is None:
        pre(model, "e2p")
        pre(model.mlp_points, "points")
        pre(model.conv1, "encoder")
        pre(model.down, "transformer")
        post(getattr(model, "up_proj", model.transformer), "decoder")
        post(model.de_conv4_0, "heads")

        def merge(*args, **kwargs):
            mark("merge")
            return saved(*args, **kwargs)

        sf.confidence_merge = merge
    else:
        pre(model, "forward")

        def loss_and_backward_marks(module, args, out):
            mark("loss")
            if out.requires_grad:
                out.register_hook(lambda g: mark("backward"))

        handles.append(model.register_forward_hook(loss_and_backward_marks))
        handles.append(optimizer.register_step_pre_hook(lambda *_: mark("optimizer")))
        handles.append(optimizer.register_step_post_hook(lambda *_: mark("end")))
    try:
        yield
    finally:
        sf.confidence_merge = saved
        for h in handles:
            h.remove()


def split_trace(path: str) -> dict:
    """Device ms by kernel name and by stage from a Chrome trace, the
    window's span and the host ms of each stage (from its mark to the next;
    ``end`` marks close a rep)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = sorted((e["ts"], e["name"][len("stage:"):]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("stage:"))
    if not marks:
        raise RuntimeError(f"no stage marks in {path}")
    starts = [t for t, _ in marks]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat", "").startswith(_LAUNCH_PREFIX) and "correlation" in e.get("args", {})}
    by_kernel = collections.defaultdict(float)
    by_stage = collections.defaultdict(float)
    span = [float("inf"), float("-inf")]
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        ms = e.get("dur", 0) / 1e3
        by_kernel[e["name"]] += ms
        t = launch.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        by_stage[marks[i][1] if i >= 0 else "before the first mark"] += ms
        span = [min(span[0], e["ts"]), max(span[1], e["ts"] + e.get("dur", 0))]
    host = collections.defaultdict(float)
    for (t0, name), (t1, _) in zip(marks, marks[1:]):
        if name != "end":
            host[name] += (t1 - t0) / 1e3
    return {"by_kernel": dict(by_kernel), "by_stage": dict(by_stage), "host_by_stage": dict(host),
            "device_window_ms": max(span[1] - span[0], 0.0) / 1e3}


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
    ap = argparse.ArgumentParser(description="profile the one-shot forward (PyTorch port)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bf16", action="store_true", help="bf16 trunk")
    ap.add_argument("--merge_dtype", choices=sorted(MERGE_DTYPES), default="f32")
    ap.add_argument("--train", action="store_true", help="train steps, not forwards")
    ap.add_argument("--reps", type=int, default=3)
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
    model = SphericalFusion(spec, dtype=torch.bfloat16 if args.bf16 else None,
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

        marks = stage_marks(model, state.optimizer)
        grad = contextlib.nullcontext()
    else:
        model.eval()

        def step(b):
            out = model(b["rgb"])
            mark("end")
            return out.sum()

        marks = stage_marks(model)
        grad = torch.inference_mode()
    prof_dir = args.profile_dir or tempfile.mkdtemp(prefix="profile_forward_")
    with grad:
        float(step(batches[0]))  # warm-up: cuDNN's choices, the tables, the kernel library
        with marks, trace(prof_dir) as prof:
            checksum = sum(float(step(b)) for b in batches)
            if on_card:
                torch.cuda.synchronize(device)
    if not np.isfinite(checksum):
        raise RuntimeError(f"non-finite result while profiling: {checksum}")
    split = split_trace(os.path.join(prof_dir, "trace.json"))
    what = "train step" if args.train else "forward"
    result = {"what": what, "batch": args.batch, "dtype": "bf16" if args.bf16 else "f32",
              "merge_dtype": args.merge_dtype, "reps": args.reps,
              "runs": args.reps + 1,  # the traced reps and the warm-up
              "device": torch.cuda.get_device_name(device) if on_card else "cpu",
              "trace": os.path.join(prof_dir, "trace.json")}
    if on_card:
        busy = sum(split["by_kernel"].values())
        if not busy:
            raise RuntimeError(f"the trace {result['trace']} holds no device time")
        result.update(
            top_kernels=table(f"device time by kernel, {what}", split["by_kernel"],
                              args.reps, args.top),
            stages=table(f"device time by stage, {what}", split["by_stage"], args.reps, 99),
            device_ms_per_rep=busy / args.reps,
            device_busy_share=busy / split["device_window_ms"],
        )
    else:
        ops = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
               if not e.key.startswith("stage:")}
        result.update(
            top_ops=table(f"host self time by operator, {what} (cpu)", ops, args.reps, args.top),
        )
    result["host_stages"] = table(f"host time by stage, {what}", split["host_by_stage"],
                                  args.reps, 99)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
