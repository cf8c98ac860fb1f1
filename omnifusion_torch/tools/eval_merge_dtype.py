"""The 16-bit merges in eval-metric terms; prints a table per size and
merge, then one JSON line.

    python -m omnifusion_torch.tools.eval_merge_dtype
    python -m omnifusion_torch.tools.eval_merge_dtype --steps 40
    python -m omnifusion_torch.tools.eval_merge_dtype --device cpu --steps 2 --train_erp 64,128 --eval_erps 64,128 --patch 32

The port's counterpart of ``tools/eval_merge_dtype.py``. The confidence
merge (pers2equi of pred * conf and conf) can read a bf16 or f16 source;
this says what that costs in the project's parity currency, the eval
metrics:

1. ``overfit``: an f32 one-shot model from seeded weights
   (``init_weights(model, 0)``) trained ``--steps`` steps at 256x512 on the
   synthetic panoramas (``make_dataset("synthetic", seed=0)``, batches of
   ``--batch``; AdamW at lr 3e-4, the trainer's ``train_step``), so that
   its predictions have a trained error scale rather than a random one;
2. ``evaluate``: the same weights with a bf16 trunk and an f32, bf16 or f16
   merge, through the trainer's ``eval_step`` (median-scaled depth
   metrics) over 4 synthetic panoramas at batch 2, at 256x512 and at the
   flagship 512x1024 (the weights do not depend on the ERP size);
3. the seven metrics of each 16-bit merge beside the f32 merge's, their
   deltas, and the relative error of their predictions against the f32
   merge's (mean, p99, max). The project's bar on abs_rel is 1e-3
   (BASELINE.json): the f16 merge's |delta abs_rel| is reported against
   it, not held to it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omnifusion_torch.cli.common import pair_arg
from omnifusion_torch.data import make_dataset
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, eval_step, train_step
from omnifusion_torch.utils.profiling import gpu_line

ABS_REL_BAR = 1e-3
CANDIDATES = {"bf16_merge": torch.bfloat16, "f16_merge": torch.float16}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the 16-bit merges in eval metrics (PyTorch port)")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--train_size", type=int, default=8)
    ap.add_argument("--train_erp", type=pair_arg, default=(256, 512))
    ap.add_argument("--eval_erps", default="256,512;512,1024",
                    help="the sizes to evaluate at, 'H,W;H,W'")
    ap.add_argument("--patch", type=pair_arg, default=(128, 128))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def batches_of(ds, batch: int, device) -> list[dict]:
    """The dataset's whole batches, in order, as tensors on ``device``."""
    out = []
    for i in range(0, len(ds) - batch + 1, batch):
        cols = zip(*(ds[j] for j in range(i, i + batch)))
        out.append({k: torch.from_numpy(np.stack(c)).to(device)
                    for k, c in zip(("rgb", "depth", "mask"), cols)})
    return out


def overfit(steps: int, batch: int, train_size: int, erp, patch, device,
            lr: float = 3e-4, log=print) -> dict:
    """The state dict of an f32 one-shot model trained ``steps`` steps on
    ``train_size`` synthetic panoramas at ``erp``."""
    spec = ProjectionSpec.create(erp, patch, (80.0, 80.0), 4)
    model = init_weights(SphericalFusion(spec, device=device), 0)
    ds = make_dataset("synthetic", size=train_size, pano_h=erp[0], pano_w=erp[1], seed=0)
    batches = batches_of(ds, batch, device)
    state = create_train_state(model, lr=lr)
    for i in range(steps):
        m = train_step(state, batches[i % len(batches)])
        if i % 25 == 0 or i == steps - 1:
            log(f"train step {i}: loss {float(m['loss']):.4f}")
    return model.state_dict()


def evaluate(state_dict: dict, erp, merge_dtype, device, dtype=torch.bfloat16,
             patch=(128, 128), size: int = 4, batch: int = 2, **model_kw):
    """The one-shot model of ``state_dict`` at ``erp`` with a ``dtype`` trunk
    and a ``merge_dtype`` merge (None: f32) over ``size`` synthetic
    panoramas at ``batch``, through ``eval_step``: (the metrics averaged
    over the valid pixels, the predictions in float64)."""
    spec = ProjectionSpec.create(erp, patch, (80.0, 80.0), 4)
    model = SphericalFusion(spec, dtype=dtype, merge_dtype=merge_dtype, device=device, **model_kw)
    model.load_state_dict(state_dict, strict=True)
    ds = make_dataset("synthetic", size=size, pano_h=erp[0], pano_w=erp[1], seed=0)
    totals, total_n, preds = {}, 0.0, []
    for b in batches_of(ds, batch, device):
        m, n, pred = eval_step(model, b)
        n = float(n)
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v) * n
        total_n += n
        preds.append(pred.double().cpu().numpy())
    return {k: v / total_n for k, v in totals.items()}, np.concatenate(preds)


def compare(state_dict: dict, erps, patch, device) -> dict:
    """For each size: the f32 merge's metrics, each 16-bit merge's, their
    deltas and the relative error of their predictions."""
    report = {}
    for erp in erps:
        a, pred_a = evaluate(state_dict, erp, None, device, patch=patch)
        tag = f"{erp[0]}x{erp[1]}"
        report[tag] = {"f32_merge": a}
        for name, mdt in CANDIDATES.items():
            b, pred_b = evaluate(state_dict, erp, mdt, device, patch=patch)
            rel = np.abs(pred_a - pred_b) / np.maximum(pred_a, 1e-3)
            report[tag][name] = b
            report[tag][f"{name}_delta"] = {k: b[k] - a[k] for k in a}
            report[tag][f"{name}_pred_rel_err"] = {
                "mean": float(rel.mean()), "p99": float(np.quantile(rel, 0.99)),
                "max": float(rel.max())}
        d = abs(report[tag]["f16_merge_delta"]["abs_rel"])
        report[tag]["f16_abs_rel_delta_vs_bar"] = {"delta": d, "bar": ABS_REL_BAR,
                                                   "within": d <= ABS_REL_BAR}
    return report


def table(report: dict) -> list[str]:
    lines = []
    for tag, r in report.items():
        lines.append(f"## {tag}")
        for name in CANDIDATES:
            lines += [f"| metric | f32 merge | {name} | delta |", "|---|---|---|---|"]
            a, b = r["f32_merge"], r[name]
            lines += [f"| {k} | {a[k]:.6f} | {b[k]:.6f} | {b[k] - a[k]:+.6f} |" for k in sorted(a)]
            lines.append("pred-vs-pred rel err: mean {mean:.2e}  p99 {p99:.2e}  max {max:.2e}"
                         .format(**r[f"{name}_pred_rel_err"]))
    return lines


def run(args, log=print) -> dict:
    device = resolve_device(args.device)
    erps = [pair_arg(e) for e in args.eval_erps.split(";")]
    sd = overfit(args.steps, args.batch, args.train_size, args.train_erp, args.patch, device,
                 log=log)
    report = compare(sd, erps, args.patch, device)
    return {"tool": "eval_merge_dtype", "steps": args.steps, "batch": args.batch,
            "train_erp": list(args.train_erp), "trunk": "bf16", "report": report,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "gpu": gpu_line() if device.type == "cuda" else None}


def main(argv=None) -> None:
    out = run(build_parser().parse_args(argv), log=lambda s: print(s, flush=True))
    for line in table(out["report"]):
        print(line)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
