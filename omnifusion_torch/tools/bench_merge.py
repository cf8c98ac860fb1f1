"""The blend kernel against torch.sparse.mm at the flagship's shapes.

    python -m omnifusion_torch.tools.bench_merge --batch 64 --dtypes f16,bf16,f32
    python -m omnifusion_torch.tools.bench_merge --device cpu --erp_size 64,128 --patchsize 32 --checks_only

The port's counterpart of ``tools/bench_pallas_merge.py``, in its order:

1. the probe (``ops/probe.py``, csrc/probe.cu) on a (256, 128) f32 tensor,
   bit for bit against ``2 * x``: it fails fast when the kernels cannot be
   built or launched, and prints ``probe ok on <device>``;
2. ``quad_blend`` at full shape against its plain version: the merge
   (64 panoramas of 2 channels, the capped tables with their tail) and
   equi2pers (64 ERPs of 3 channels, channel-last);
3. per dtype of ``--dtypes``, at ``--batch``, the merge and equi2pers
   through the kernel, through ``torch.sparse.mm`` with the same map as a
   CSR matrix in that dtype (the library yardstick; its operand is laid
   out (pixels, rows) once, outside the timing) and through the plain
   version (printed, no yardstick), beside the bound (bytes over 3.35
   TB/s).

One JSON line per check and per timing. Times come from CUDA events on
the card and from the host clock on the CPU (``timed_on``). A failed check
raises.
"""

from __future__ import annotations

import argparse
import json

import torch

from omnifusion_torch.cli.common import pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.ops.probe import probe, probe_plain
from omnifusion_torch.ops.quad_blend import quad_blend, quad_blend_plain
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.utils.profiling import blend_bound, blend_matrix, time_ms

DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
# inputs in [0, 1), weights summing to <= 1: f32 rounding of a 4*K-term sum
# taken in another order
BLEND_TOL = 2e-6
CHECK_BATCH = 64  # the JAX tool's


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="blend kernel vs torch.sparse.mm (PyTorch port)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtypes", default="f16,bf16,f32")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--checks_only", action="store_true", help="the probe and the checks")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def run(args) -> list[dict]:
    device = resolve_device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    timed_on = "cuda events" if device.type == "cuda" else "cpu host clock"
    g = torch.Generator(device=device).manual_seed(0)

    x = torch.randn(256, 128, device=device, generator=g)
    got = probe(x)
    if not torch.equal(got, probe_plain(x)):
        raise AssertionError("the probe's 2 * x differs from the plain version's")
    print(f"probe ok on {where}", flush=True)
    lines = [{"probe": "ok", "shape": [256, 128], "device": where}]

    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    merge, e2p = pers2equi_tables(spec, device), equi2pers_tables(spec, device)
    n_erp = spec.erp_h * spec.erp_w
    cases = {  # name: (tables, channel_last, batch -> source shape)
        "merge": (merge, False, lambda b: (b, 2, merge.n_in)),
        "e2p": (e2p, True, lambda b: (b, n_erp, 3)),
    }
    for name, (tables, cl, shape) in cases.items():
        src = torch.rand(shape(CHECK_BATCH), device=device, generator=g)
        err = (quad_blend(src, tables, channel_last=cl)
               - quad_blend_plain(src, tables, channel_last=cl)).abs().max().item()
        lines.append({"check": name, "shape": list(src.shape), "max_abs_err": err,
                      "tol": BLEND_TOL, "device": where})
        print(json.dumps(lines[-1]), flush=True)
        if not err <= BLEND_TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs err {err} > {BLEND_TOL}")
    if args.checks_only:
        return lines

    for dt_name in args.dtypes.split(","):
        dtype = DTYPES[dt_name]
        for name, (tables, cl, shape) in cases.items():
            src = torch.rand(shape(args.batch), device=device, generator=g).to(dtype)
            out = quad_blend(src, tables, channel_last=cl)
            dense = (src.permute(1, 0, 2) if cl else src.permute(2, 0, 1))
            dense = dense.reshape(tables.n_in, -1).contiguous()
            csr = blend_matrix(tables, dtype)
            b_ms, b_by = blend_bound(src, tables, out)
            lines.append({
                "case": f"{name}/{dt_name}", "shape": list(src.shape), "timed_on": timed_on,
                "ms": time_ms(lambda: quad_blend(src, tables, channel_last=cl), device,
                              iters=args.reps),
                "library_ms": time_ms(lambda: torch.sparse.mm(csr, dense), device,
                                      iters=args.reps),
                "plain_ms": time_ms(lambda: quad_blend_plain(src, tables, channel_last=cl),
                                    device, iters=2, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by,
            })
            print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
