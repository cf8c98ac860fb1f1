"""What bounds the quad_blend kernel: it timed beside copies of itself with
one part taken out, one JSON line per call.

    python -m omnifusion_torch.tools.blend_variants
    python -m omnifusion_torch.tools.blend_variants --batches 2,64 --cases merge_f16

Builds three patched copies of csrc/quad_blend.cu next to the kernel (each
its own shared library, with nvcc, in a temporary directory): ``no_store``
(the output is written only where a sum is 1234.5, which no input here
gives), ``no_copy`` (nothing is staged: the blend reads whatever shared
memory holds) and ``no_blend`` (every quad skipped: the stores of zeros,
the table reads and the staging remain). Each is timed at the flagship's merge (f16, f32) and equi2pers
(bf16, f32) calls, staged and gathering from global memory, beside the
kernel as it stands, with the module's plan for the call (``blend_plan``).
The results of the copies are wrong by design: this only times them. Needs
the card; CUDA events.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from omnifusion_torch.cli.common import pair_arg
from omnifusion_torch.device import resolve_device
from omnifusion_torch.ops import _build
from omnifusion_torch.ops import quad_blend as qb
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.utils.profiling import blend_bound, gpu_line, time_ms

# (name, text of csrc/quad_blend.cu, its replacement)
PATCHES = (
    ("no_store", "o[ch] = from_f32<O>(acc);", "if (acc == 1234.5f) o[ch] = from_f32<O>(acc);"),
    ("no_copy", "for (int i = tid; i < per_unit; i += n_threads) {",
     "for (int i = tid; i < 0; i += n_threads) {"),
    ("no_blend", "if (e < n_e) {\n                  acc +=", "if (e < 0) {\n                  acc +="),
)
CASES = {"merge_f16": ("merge", torch.float16), "merge_f32": ("merge", torch.float32),
         "e2p_bf16": ("e2p", torch.bfloat16), "e2p_f32": ("e2p", torch.float32)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="quad_blend beside copies with a part taken out")
    ap.add_argument("--batches", default="64,256", help="panoramas per call")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    ap.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    ap.add_argument("--iters", type=int, default=10)
    return ap


def build_variants(out_dir: str) -> dict:
    """The patched copies, each loaded as a ctypes library."""
    with open(os.path.join(_build.CSRC, "quad_blend.cu")) as f:
        text = f.read()
    procs = {}
    for name, old, new in PATCHES:
        if old not in text:
            raise RuntimeError(f"blend_variants: {name}: csrc/quad_blend.cu no longer holds {old!r}")
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text.replace(old, new))
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(so)
        fn = lib.omnifusion_quad_blend
        fn.argtypes, fn.restype = list(_build._SIGNATURES["omnifusion_quad_blend"]), ctypes.c_int
        libs[name] = lib
    return libs


def run(args) -> list[dict]:
    device = resolve_device(None)  # the card, or raises
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (80.0, 80.0), 4)
    tables = {"merge": pers2equi_tables(spec, device), "e2p": equi2pers_tables(spec, device)}
    rng = np.random.default_rng(0)
    gpu = gpu_line()
    library = _build.library
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"kernel": library(), **build_variants(tmp)}
        try:
            for case in args.cases.split(","):
                kind, dtype = CASES[case]
                cl, t = kind == "e2p", tables[kind]
                for b in (int(v) for v in args.batches.split(",")):
                    shape = (b, t.n_in, 3) if cl else (b, 2, t.n_in)
                    x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device, dtype)
                    out_dtype = dtype if cl else None  # as equi2pers and the merge store
                    staged = qb.blend_plan(t.tiles, b if cl else 2 * b, 3 if cl else 1,
                                           x.element_size())[0]
                    row = {"case": case, "batch": b, "gpu": gpu, "plan_staged": staged,
                           "bound_ms": blend_bound(x, t, qb.quad_blend(x, t, cl, out_dtype))[0]}
                    for name, lib in libs.items():
                        _build.library = lambda lib=lib: lib  # noqa: E731
                        for st in (True, False):
                            if name == "no_copy" and not st:
                                continue
                            row[f"{name}_{'staged' if st else 'global'}_ms"] = time_ms(
                                lambda st=st: qb._blend_kernel(x, t, cl, out_dtype, staged=st),
                                device, args.iters, 3)
                    rows.append(row)
                    del x
                    torch.cuda.empty_cache()
        finally:
            _build.library = library
    return rows


def main(argv=None) -> None:
    for row in run(build_parser().parse_args(argv)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
