"""Times of quad_blend, quad_spread, up2x and its adjoint at the main paths'
shapes, one JSON line.

    python -m omnifusion_torch.tools.bench_kernels
    PYTHONPATH=other_checkout python omnifusion_torch/tools/bench_kernels.py
    python -m omnifusion_torch.tools.bench_kernels --device cpu --erp_size 64,128 --patchsize 32

At the flagship config (512x1024 ERP, patch 128, fov 80, nrows 4):
quad_blend at the merge (2 channels, f16 and f32) and at equi2pers (3
channels, bf16 and f32) at each of ``--blend_batches`` panoramas, beside its
bound (``blend_bound``) and torch.sparse.mm on a pixel-major copy of the
source; equi2pers itself (the blend and its result in the ERP's dtype);
the iterative model's quarter-resolution equi2pers (a 1-channel f32 depth
into patches of a quarter of the side) at ``--e2p_q_batches``, and the merge
at nrows 6, fov 90 (9 quads on some pixels, one past the kernel's register
budget; a version of the port that refuses it reports ``refused``) at
``--blend_batches``; quad_spread at the merge's backward (f32 cotangent,
``--train_batch`` panoramas) and at the quarter-resolution equi2pers's
(channel-last, 1 channel), up2x summed over the decoder's five upsamples
(``--batch`` panoramas) and up2x_adjoint over their five adjoints (the
train step's, ``--train_batch`` panoramas), each in f32 and in the bf16
recipe (the first stage f32, the rest bf16), each beside its bound. It uses
only entry points that every version of the port has had since its bf16
recipe, so run as a file with another
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
from omnifusion_torch.cli.common import pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.ops.quad_blend import quad_blend, quad_spread
from omnifusion_torch.ops.upsample import up2x, up2x_adjoint
from omnifusion_torch.projection import ProjectionSpec, equi2pers
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.projection.spec import build_equi2pers_grids
from omnifusion_torch.utils.profiling import (
    blend_bound, blend_matrix, bound_ms, gpu_line, nbytes, time_ms,
)

# the decoder's upsamples: (channels, input side / patch side); the
# flagship's patch 128 gives sides 4, 8, 16, 32, 64
DECODER = ((512, 1 / 32), (128, 1 / 16), (64, 1 / 8), (64, 1 / 4), (32, 1 / 2))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the kernels' times (PyTorch port)")
    ap.add_argument("--batch", type=int, default=2, help="panoramas per forward (up2x)")
    ap.add_argument("--train_batch", type=int, default=8,
                    help="panoramas per step (quad_spread, up2x_adjoint)")
    ap.add_argument("--blend_batches", default="2,64,256", help="panoramas per quad_blend call")
    ap.add_argument("--e2p_q_batches", default="2,8,64",
                    help="panoramas per quarter-resolution equi2pers call")
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def _batches(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def run(args) -> dict:
    device = resolve_device(args.device)
    timer = lambda fn: time_ms(fn, device, iters=args.iters, warmup=3)  # noqa: E731
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    spec_q = spec.with_patch_scale(4)
    spec_n6 = ProjectionSpec.create(args.erp_size, args.patchsize, (90.0, 90.0), 6)
    rng = np.random.default_rng(0)
    blend = {}
    grids = {s: build_equi2pers_grids(s) for s in (spec, spec_q)}
    blend_batches = _batches(args.blend_batches)
    for case, tables, c, cl, dtypes, batches in (
        ("merge", pers2equi_tables(spec, device), 2, False, (torch.float16, torch.float32),
         blend_batches),
        ("e2p", equi2pers_tables(spec, device), 3, True, (torch.bfloat16, torch.float32),
         blend_batches),
        ("e2p_q", equi2pers_tables(spec_q, device), 1, True, (torch.float32,),
         _batches(args.e2p_q_batches)),
        ("merge_n6", pers2equi_tables(spec_n6, device), 2, False,
         (torch.float16, torch.float32), blend_batches),
    ):
        for b in batches:
            shape = (b, tables.n_in, c) if cl else (b, c, tables.n_in)
            x32 = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
            for dtype in dtypes:
                x = x32.to(dtype)
                try:
                    out = quad_blend(x, tables, channel_last=cl)
                except ValueError as e:  # a version with a limit of quads per pixel
                    if "quads for one pixel" not in str(e):
                        raise
                    blend[f"{case}_{str(dtype)[6:]}_b{b}"] = {"shape": list(shape),
                                                             "refused": str(e)}
                    continue
                row = {"shape": list(shape), "ms": timer(lambda: quad_blend(x, tables, channel_last=cl)),
                       "bound_ms": blend_bound(x, tables, out)[0]}
                del out
                if cl:  # the public op: its result in the ERP's dtype
                    erp = x.reshape(b, spec.erp_h, spec.erp_w, c)
                    g = grids[spec_q if case == "e2p_q" else spec]
                    row["equi2pers_ms"] = timer(lambda: equi2pers(erp, g))
                if device.type == "cuda":  # the CPU has no 16-bit sparse product
                    w_csr = blend_matrix(tables, dtype)
                    dense = (x.permute(1, 0, 2) if cl else x.permute(2, 0, 1)).reshape(tables.n_in, -1)
                    dense = dense.contiguous()
                    row["library_ms"] = timer(lambda: torch.sparse.mm(w_csr, dense))
                    del w_csr, dense
                blend[f"{case}_{str(dtype)[6:]}_b{b}"] = row
            del x32, x
            if device.type == "cuda":
                torch.cuda.empty_cache()
    t = pers2equi_tables(spec, device).vjp
    cot = torch.from_numpy(rng.random((args.train_batch, 2, t.n_out), dtype=np.float32)).to(device)
    spread = {"shape": list(cot.shape), "ms": timer(lambda: quad_spread(cot, t))}
    t_q = equi2pers_tables(spec_q, device).vjp
    cot_q = torch.from_numpy(
        rng.random((args.train_batch, t_q.n_out, 1), dtype=np.float32)).to(device)
    spread["e2p_q"] = {"shape": list(cot_q.shape),
                       "ms": timer(lambda: quad_spread(cot_q, t_q, channel_last=True))}

    ups, adjoints = {}, {}
    for recipe in ("f32", "bf16"):
        rows, adj_rows = [], []
        for i, (c, frac) in enumerate(DECODER):
            side = max(1, int(spec.patch_h * frac))
            dtype = torch.bfloat16 if recipe == "bf16" and i > 0 else torch.float32
            x = torch.from_numpy(
                rng.random((args.batch * spec.n_patches, c, side, side), dtype=np.float32)
            ).to(device, dtype)
            b_ms, _ = bound_ms(5 * nbytes(x), 9.0 * 4 * x.numel())
            rows.append({"shape": list(x.shape), "dtype": str(x.dtype)[6:],
                         "ms": timer(lambda: up2x(x)), "bound_ms": b_ms})
            g = torch.from_numpy(rng.random(
                (args.train_batch * spec.n_patches, c, 2 * side, 2 * side), dtype=np.float32)
            ).to(device, dtype)
            b_ms, _ = bound_ms(nbytes(g) + nbytes(g) // 4, 15.0 * g.numel() / 4)
            adj_rows.append({"shape": list(g.shape), "dtype": str(g.dtype)[6:],
                             "ms": timer(lambda: up2x_adjoint(g)), "bound_ms": b_ms})
        ups[recipe] = {"ms": sum(r["ms"] for r in rows),
                       "bound_ms": sum(r["bound_ms"] for r in rows), "shapes": rows}
        adjoints[recipe] = {"ms": sum(r["ms"] for r in adj_rows),
                            "bound_ms": sum(r["bound_ms"] for r in adj_rows), "shapes": adj_rows}
    return {
        "port": os.path.dirname(os.path.abspath(omnifusion_torch.__file__)),
        "gpu": gpu_line() if device.type == "cuda" else None,
        "timed_on": "cuda events" if device.type == "cuda" else "cpu host clock",
        "quad_blend": blend, "quad_spread": spread, "up2x": ups, "up2x_adjoint": adjoints,
    }


def main(argv=None) -> None:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
