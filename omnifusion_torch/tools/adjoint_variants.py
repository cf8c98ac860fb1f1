"""What bounds the up2x adjoint kernel: it timed beside copies of itself
built another way, at the decoder's five stages, one JSON line per stage and
one per recipe.

    python -m omnifusion_torch.tools.adjoint_variants
    python -m omnifusion_torch.tools.adjoint_variants --source other=path/to/up2x.cu

Builds patched copies of csrc/up2x.cu (each its own shared library, with
nvcc, in a temporary directory): ``one_output`` (a thread per output, its 16
cotangents in scalar loads, the index split by FastDiv),
``one_output_divide`` (the same with the split by runtime division and
modulo), ``scalar_loads`` (the 1x4 block, its band element by element),
``rows2`` and ``rows4`` (2x4 and 4x4 blocks) and ``cols8`` (1x8 blocks);
``--source name=path`` adds another version of the file, built as it is.
Each is timed with a warm L2 and with L2 flushed before each call, at the
decoder's five adjoints of ``--batch`` panoramas (flagship, patch 128: 512
channels 4x4 ... 32 channels 64x64 outputs), on f32 cotangents and in the
bf16 recipe (the first stage f32), beside the kernel as it stands and the
stage's bound. Each copy computes the same function: its result is held to
up2x_adjoint_plain (``bitwise_equal``, and the largest difference). Needs
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

from omnifusion_torch.device import resolve_device
from omnifusion_torch.ops import _build
from omnifusion_torch.ops import upsample as ups
from omnifusion_torch.utils.profiling import bound_ms, gpu_line, nbytes, time_ms, time_ms_flushed

ROWS, COLS = "constexpr int kAdjRows = 1;", "constexpr int kAdjCols = 4;"
# (name, [(text of csrc/up2x.cu, its replacement)])
PATCHES = (
    ("one_output", [(COLS, COLS.replace("4", "1"))]),
    ("one_output_divide", [
        (COLS, COLS.replace("4", "1")),
        ("const uint32_t r = divide(t, col_groups);", "const uint32_t r = t / col_groups.d;"),
        ("const uint32_t plane = divide(r, row_groups);",
         "const uint32_t plane = r / row_groups.d;"),
    ]),
    ("scalar_loads", [("constexpr bool kAdjVector = kAdjCols % 4 == 0;",
                       "constexpr bool kAdjVector = false;")]),
    ("rows2", [(ROWS, ROWS.replace("1", "2"))]),
    ("rows4", [(ROWS, ROWS.replace("1", "4"))]),
    ("cols8", [(COLS, COLS.replace("4", "8"))]),
)
# the decoder's adjoints: (channels, output side) at patch 128
STAGES = ((512, 4), (128, 8), (64, 16), (64, 32), (32, 64))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the up2x adjoint beside copies built another way")
    ap.add_argument("--batch", type=int, default=8, help="panoramas (18 patches each)")
    ap.add_argument("--source", action="append", default=[],
                    help="name=path: another up2x.cu to build as it is (repeatable)")
    ap.add_argument("--iters", type=int, default=20)
    return ap


def _sources(extra: list[str]) -> dict:
    """{name: text}: the patched copies of csrc/up2x.cu and the sources
    given as name=path."""
    with open(os.path.join(_build.CSRC, "up2x.cu")) as f:
        text = f.read()
    out = {}
    for name, edits in PATCHES:
        patched = text
        for old, new in edits:
            if patched.count(old) != 1:
                raise RuntimeError(f"adjoint_variants: {name}: csrc/up2x.cu does not hold {old!r} once")
            patched = patched.replace(old, new)
        out[name] = patched
    for item in extra:
        name, sep, path = item.partition("=")
        if not sep or not name or name in out or name == "kernel":
            raise ValueError(f"adjoint_variants: --source wants a new name=path, got {item!r}")
        with open(path) as f:
            out[name] = f.read()
    return out


def build_variants(texts: dict, out_dir: str) -> dict:
    """Each text built by its own nvcc, all started together, and loaded as
    a ctypes library."""
    procs = {}
    for name, text in texts.items():
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(so)
        fn = lib.omnifusion_up2x_adjoint
        fn.argtypes, fn.restype = list(_build._SIGNATURES["omnifusion_up2x_adjoint"]), ctypes.c_int
        libs[name] = lib
    return libs


def run(args) -> list[dict]:
    device = resolve_device(None)  # the card, or raises
    texts = _sources(args.source)
    rng = np.random.default_rng(0)
    gpu = gpu_line()
    library = _build.library
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"kernel": library(), **build_variants(texts, tmp)}
        try:
            for recipe in ("f32", "bf16"):
                total = {}
                for i, (c, side) in enumerate(STAGES):
                    dtype = torch.bfloat16 if recipe == "bf16" and i > 0 else torch.float32
                    g = torch.from_numpy(rng.random(
                        (args.batch * 18, c, 2 * side, 2 * side), dtype=np.float32)).to(device, dtype)
                    want = ups.up2x_adjoint_plain(g)
                    row = {"recipe": recipe, "shape": list(g.shape), "dtype": str(dtype)[6:],
                           "gpu": gpu,
                           "bound_ms": bound_ms(nbytes(g, want), 15.0 * want.numel())[0]}
                    for name, lib in libs.items():
                        _build.library = lambda lib=lib: lib  # noqa: E731
                        got = ups._adjoint_kernel(g)
                        torch.cuda.synchronize()
                        row[f"{name}_bitwise_equal"] = torch.equal(got, want)
                        row[f"{name}_max_abs_err"] = (got.float() - want.float()).abs().max().item()
                        del got
                        row[f"{name}_ms"] = time_ms(lambda: ups._adjoint_kernel(g), device,
                                                    args.iters, 3)
                        row[f"{name}_ms_l2_flushed"] = time_ms_flushed(
                            lambda: ups._adjoint_kernel(g), device, args.iters, 3)
                    for k, v in row.items():
                        if k.endswith(("_ms", "_ms_l2_flushed")):
                            total[k] = total.get(k, 0.0) + v
                    rows.append(row)
                    del g, want
                    torch.cuda.empty_cache()
                rows.append({"recipe": recipe, "stages": len(STAGES), "batch": args.batch,
                             "gpu": gpu, "sum": total})
        finally:
            _build.library = library
    return rows


def main(argv=None) -> None:
    for row in run(build_parser().parse_args(argv)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
