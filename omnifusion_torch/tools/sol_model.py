"""Speed-of-light floor of the flagship forward, and of the train step, on
this card; prints its table, then one JSON line.

    python -m omnifusion_torch.tools.sol_model --batch 8 --train
    python -m omnifusion_torch.tools.sol_model --calibrate --train --batch 8
    python -m omnifusion_torch.tools.sol_model --device cpu --erp_size 64,128 --patchsize 32 --batch 2 --train

The port's counterpart of ``tools/sol_model.py``: how fast the bf16 recipe
(bf16 trunk, f16 merge; ``--model iterative``: 2 passes, each merge of the
depth alone, as the iterative model serves) could run, from the work its
own shapes and tables need:

- the convolutions and matmuls, each recorded as it runs in one forward at
  ``--batch`` (a dispatch mode sees every ``aten.convolution``, ``mm``,
  ``addmm``, ``bmm`` and ``baddbmm``: the fused heads' ``F.conv2d`` too),
  each at the larger of its FLOPs over the peak of its dtype and its input,
  weight and output bytes over the memory rate (the conv roofline floor);
- the upsamples, recorded by forward pre-hooks on the five decoder
  convolutions that read them (``de_conv*_0``), and the blends (equi2pers
  of the ERP, the merge of each pass, the quarter-resolution equi2pers of
  the iterative model), at the bytes and operations that the port's
  kernels must move and do (``utils.profiling.blend_work`` on the real
  tables, ``up2x_work``; each row's ``bound_ms`` is the one the kernels'
  time rows of chip_smoke.py give);
- with ``--train``, the step: the convolutions and matmuls three times
  (forward, data and weight gradients), each upsample and its adjoint, the
  blends and the spreads of every blend that takes a gradient, and AdamW's
  8 x 4 bytes per parameter.

The whole-forward floor is the sum over those stages; the BatchNorms, ReLUs,
concatenations and casts are not in it (a fused trunk would not move them
on their own). ``flops_t`` is the forward's count from shapes
(``utils.profiling.count_flops``). The geometric embedding of the one-shot
model runs once per batch, so its FLOPs do not grow with the batch. Rates:
the datasheet's 3.35 TB/s and ``PEAK_FLOPS``; ``--calibrate`` also measures
a streaming copy over 2 GiB and a chain of 8 bf16 matmuls of 8192^3, each
product feeding the next, and prints them beside the card's name and power
limit; ``--stream_gbs`` and ``--matmul_tflops`` put measured rates in place
of the datasheet's. The accounting runs on the CPU as on the card
(``--device cpu``, at a size the CPU can run); ``--calibrate`` needs the
card.

Not carried over from the JAX tool, each for its reason: the TPU's lane
padding and its "lane-aware" matrix-unit estimate (the H100's tensor cores
tile otherwise), the per-index gather cost table and the XLA two-pass
resize (the port's kernels are other programs), and its measured rates
(another device).
"""

from __future__ import annotations

import argparse
import json
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from omnifusion_torch.cli.common import pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.utils.profiling import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    blend_work,
    bound_ms,
    count_flops,
    gpu_line,
    nbytes,
    spread_work,
    time_ms,
    up2x_adjoint_work,
    up2x_work,
)

# the decoder convolutions that read an upsample's output (DepthTrunk.trunk)
RESIZE_READERS = ("de_conv0_0", "de_conv1_0", "de_conv2_0", "de_conv3_0", "de_conv4_0")
STREAM_BYTES = 2 * 2**30  # --calibrate: the copy's source
MATMUL_N, MATMUL_CHAIN = 8192, 8
ADAMW_BYTES_PER_PARAM = 8 * 4  # reads p, m, v, g and writes p, m, v, g once, f32


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="speed-of-light floor (PyTorch port)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--model", choices=("oneshot", "iterative"), default="oneshot")
    ap.add_argument("--train", action="store_true", help="the train step's bound too")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the card's copy and bf16 matmul rates (card only)")
    ap.add_argument("--stream_gbs", type=float, default=None,
                    help="memory rate in GB/s (default: the datasheet's 3350)")
    ap.add_argument("--matmul_tflops", type=float, default=None,
                    help="bf16 rate in TFLOP/s (default: the datasheet's dense peak)")
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


class _Recorder(TorchDispatchMode):
    """Every convolution and matmul that runs under it: (FLOPs, bytes,
    dtype) each, from the shapes of its operands and result."""

    def __init__(self):
        super().__init__()
        self.convs, self.matmuls = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        if func is aten.convolution.default:
            x, w = args[0], args[1]
            groups = args[8]
            flops = 2.0 * out.numel() * math.prod(w.shape[1:])  # 2 |out| kh kw cin / groups
            self.convs.append({"input": list(x.shape), "weight": list(w.shape),
                               "output": list(out.shape), "groups": groups,
                               "dtype": str(x.dtype)[6:], "flops": flops,
                               "bytes": nbytes(x, w, out)})
        elif func in (aten.mm.default, aten.bmm.default, aten.addmm.default,
                      aten.baddbmm.default):
            a, b = (args[1], args[2]) if func in (aten.addmm.default,
                                                  aten.baddbmm.default) else args[:2]
            self.matmuls.append({"op": str(func.overloadpacket), "a": list(a.shape),
                                 "b": list(b.shape), "dtype": str(a.dtype)[6:],
                                 "flops": 2.0 * out.numel() * a.shape[-1],
                                 "bytes": nbytes(a, b, out)})
        return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _precision(dtype: str, tf32: bool) -> str:
    if dtype in ("bfloat16", "float16"):
        return "bf16"
    return "tf32" if tf32 else "f32"


def calibrate(device) -> dict:
    """The card's rates: a copy of STREAM_BYTES (read and written once per
    copy) and a chain of MATMUL_CHAIN bf16 products of MATMUL_N^3, each
    feeding the next; device time from CUDA events (utils.profiling.time_ms)."""
    src = torch.ones(STREAM_BYTES // 4, device=device)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), device, iters=10, warmup=2)
    del src, dst
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(MATMUL_N, MATMUL_N, device=device, generator=g, dtype=torch.bfloat16)
    # a random matrix scaled by 1 / sqrt(N) keeps the chain's values near 1
    b = (torch.randn(MATMUL_N, MATMUL_N, device=device, generator=g) / MATMUL_N ** 0.5
         ).to(torch.bfloat16)

    def chain():
        c = a
        for _ in range(MATMUL_CHAIN):
            c = c @ b
        return c

    mm_ms = time_ms(chain, device, iters=5, warmup=2)
    finite = bool(torch.isfinite(chain()).all())
    del a, b
    torch.cuda.empty_cache()
    return {"stream_gbs": 2 * STREAM_BYTES / (copy_ms / 1e3) / 1e9, "copy_ms": copy_ms,
            "copy_bytes": 2 * STREAM_BYTES,
            "matmul_tflops": MATMUL_CHAIN * 2.0 * MATMUL_N**3 / (mm_ms / 1e3) / 1e12,
            "matmul_ms": mm_ms, "matmul": f"{MATMUL_CHAIN} chained bf16 {MATMUL_N}^3",
            "matmul_finite": finite, "gpu": gpu_line()}


def account(args) -> dict:
    device = resolve_device(args.device)
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    kw = dict(dtype=torch.bfloat16, merge_dtype=torch.float16, device=device)
    iters = 2 if args.model == "iterative" else 1
    model = (SphericalFusionIterative(spec, num_iters=iters, **kw) if iters > 1
             else SphericalFusion(spec, **kw))
    init_weights(model, 0).eval()
    b = args.batch
    x = torch.rand(b, *args.erp_size, 3, device=device,
                   generator=torch.Generator(device=device).manual_seed(0))

    resizes = []
    hooks = [getattr(model, name).register_forward_pre_hook(
        lambda mod, inp: resizes.append((list(inp[0].shape), inp[0].dtype)))
        for name in RESIZE_READERS]
    rec = _Recorder()
    # no_grad, not inference_mode: under inference_mode the composite ops
    # (aten.conv2d, aten.linear) reach the dispatch mode undecomposed
    try:
        with torch.no_grad(), rec:
            model(x)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        flops = count_flops(lambda: model(x))
    forwards = 2
    n_params = sum(p.numel() for p in model.parameters())
    del model, x

    rate = (args.stream_gbs * 1e9) if args.stream_gbs else HBM_BYTES_PER_S
    peaks = dict(PEAK_FLOPS)
    if args.matmul_tflops:
        peaks["bf16"] = args.matmul_tflops * 1e12
    tf32_conv = torch.backends.cudnn.allow_tf32
    tf32_mm = torch.backends.cuda.matmul.allow_tf32

    def floor(n_bytes, n_flops, precision="f32") -> float:
        return max(n_bytes / rate * 1e3, n_flops / peaks[precision] * 1e3)

    conv_floor = sum(floor(c["bytes"], c["flops"], _precision(c["dtype"], tf32_conv))
                     for c in rec.convs)
    mm_floor = sum(floor(m["bytes"], m["flops"], _precision(m["dtype"], tf32_mm))
                   for m in rec.matmuls)

    # the kernels' rows: (stage, kernel, calls, (bytes, ops) of one call)
    n_erp, n_pp = spec.erp_h * spec.erp_w, spec.n_patches * spec.patch_h * spec.patch_w
    t_e2p, t_p2e = equi2pers_tables(spec, device), pers2equi_tables(spec, device)
    merge_rows = 2 if iters == 1 else 1  # pred * conf and conf; the depth alone
    fwd = [("equi2pers", "quad_blend", 1,
            blend_work(_meta((b, n_erp, 3), torch.bfloat16), t_e2p,
                       _meta((b, n_pp, 3), torch.bfloat16))),
           ("merge", "quad_blend", iters,
            blend_work(_meta((b, merge_rows, n_pp), torch.float16), t_p2e,
                       _meta((b, merge_rows, n_erp), torch.float32)))]
    bwd = [("merge spread", "quad_spread", iters,
            spread_work(_meta((b, merge_rows, n_erp), torch.float32), t_p2e.vjp,
                        _meta((b, merge_rows, n_pp), torch.float32)))]
    if iters > 1:
        spec_q = spec.with_patch_scale(4)
        t_q = equi2pers_tables(spec_q, device)
        n_q = spec_q.n_patches * spec_q.patch_h * spec_q.patch_w
        fwd.append(("quarter equi2pers", "quad_blend", iters - 1,
                    blend_work(_meta((b, n_erp, 1), torch.float32), t_q,
                               _meta((b, n_q, 1), torch.float32))))
        bwd.append(("quarter equi2pers spread", "quad_spread", iters - 1,
                    spread_work(_meta((b, n_q, 1), torch.float32), t_q.vjp,
                                _meta((b, n_erp, 1), torch.float32))))
    for shape, dtype in resizes:
        # the upsample's input: half the side of what the convolution reads
        src = _meta((*shape[:2], shape[2] // 2, shape[3] // 2), dtype)
        name = "x".join(map(str, src.shape)) + f"_{str(dtype)[6:]}"
        fwd.append((f"up2x {name}", "up2x", 1, up2x_work(src)))
        bwd.append((f"up2x_adjoint {name}", "up2x_adjoint", 1, up2x_adjoint_work(src)))

    def rows_of(stages):
        return [{"stage": s, "kernel": k, "calls": n, "bytes": w[0], "operations": w[1],
                 # the datasheet's bound of one call (chip_smoke.py's time rows)
                 "floor_ms": n * floor(*w), "bound_ms": bound_ms(*w)[0]}
                for s, k, n, w in stages]

    fwd_rows = rows_of(fwd)
    forward_floor = conv_floor + mm_floor + sum(r["floor_ms"] for r in fwd_rows)
    out = {
        "model": args.model, "batch": b, "erp": list(args.erp_size),
        "patch": list(args.patchsize), "recipe": "bf16 trunk + f16 merge",
        "flops_t": flops["total"] / 1e12, "flops_by_op": flops["by_op"],
        "convs": len(rec.convs), "conv_flops_t": sum(c["flops"] for c in rec.convs) / 1e12,
        "conv_bytes_gb": sum(c["bytes"] for c in rec.convs) / 1e9,
        "matmuls": len(rec.matmuls), "matmul_flops_t": sum(m["flops"] for m in rec.matmuls) / 1e12,
        "conv_floor_ms": conv_floor, "matmul_floor_ms": mm_floor,
        "forward_floor_ms": forward_floor, "rows": fwd_rows,
        "rates": {"stream_gbs": rate / 1e9,
                  "peak_tflops": {k: v / 1e12 for k, v in peaks.items()},
                  "conv_precision_f32": "tf32" if tf32_conv else "f32",
                  "from": "measured" if (args.stream_gbs or args.matmul_tflops) else "datasheet"},
        "conv_shapes": rec.convs,
        "resize_shapes": [{"output": s, "dtype": str(dt)[6:]} for s, dt in resizes],
        "train_bound_ms": None, "params": n_params, "forwards": forwards,
    }
    if args.train:
        bwd_rows = rows_of(bwd)
        opt_ms = n_params * ADAMW_BYTES_PER_PARAM / rate * 1e3
        out.update(train_rows=bwd_rows, optimizer_ms=opt_ms, train_bound_ms=(
            3 * (conv_floor + mm_floor) + sum(r["floor_ms"] for r in fwd_rows + bwd_rows)
            + opt_ms))
    return out


def run(args) -> dict:
    device = resolve_device(args.device)
    if args.calibrate and device.type != "cuda":
        raise SystemExit("sol_model --calibrate measures the card: it needs a CUDA device")
    cal = calibrate(device) if args.calibrate else None
    out = account(args)
    out["calibration"] = cal
    out["gpu"] = gpu_line() if device.type == "cuda" else None
    return out


def report(out: dict) -> list[str]:
    lines = [f"batch {out['batch']}, {out['model']} {out['erp'][0]}x{out['erp'][1]}/"
             f"p{out['patch'][0]}/f80/n4, {out['recipe']}"]
    if out["calibration"]:
        c = out["calibration"]
        lines.append(f"stream copy: {c['stream_gbs']:.1f} GB/s; {c['matmul']}: "
                     f"{c['matmul_tflops']:.1f} TFLOP/s  ({c['gpu']})")
    lines.append(f"convs: {out['convs']} ops, {out['conv_flops_t']:.3f} TFLOP, "
                 f"{out['conv_bytes_gb']:.2f} GB -> roofline floor {out['conv_floor_ms']:.3f} ms")
    lines.append(f"matmuls: {out['matmuls']} ops, {out['matmul_flops_t']:.4f} TFLOP -> "
                 f"{out['matmul_floor_ms']:.3f} ms")
    lines.append(f"model FLOPs (counted from shapes): {out['flops_t']:.3f} TFLOP")
    lines.append(f"{'stage':40s} {'calls':>5s} {'floor ms':>10s}")
    for r in out["rows"] + out.get("train_rows", []):
        lines.append(f"{r['stage']:40s} {r['calls']:5d} {r['floor_ms']:10.4f}")
    lines.append(f"forward floor: {out['forward_floor_ms']:.3f} ms")
    if out["train_bound_ms"] is not None:
        lines.append(f"optimizer (AdamW, {out['params'] / 1e6:.1f}M params): "
                     f"{out['optimizer_ms']:.3f} ms")
        lines.append(f"train-step bound: {out['train_bound_ms']:.3f} ms "
                     "(+ BatchNorm, loss and layout passes)")
    return lines


def main(argv=None) -> None:
    out = run(build_parser().parse_args(argv))
    for line in report(out):
        print(line)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
