"""Registers, spills and machine code of each instantiation of a CUDA
source, and of two versions of it side by side, one JSON line.

    python -m omnifusion_torch.tools.kernel_registers omnifusion_torch/csrc/quad_blend.cu
    python -m omnifusion_torch.tools.kernel_registers new.cu --against old.cu

Compiles each source with the port's nvcc flags (ops/_build.py) to a cubin
with ``-Xptxas -v``, reads each kernel's registers, spill stores and loads
and shared memory from ptxas, and its SASS from cuobjdump. With
``--against``, the kernels of the two sources are paired by their
demangled names, a template argument that only the newer source has
(a trailing ``false``, a path that the older one lacked, switched off)
left out, and each pair is reported as the same machine code or not
(instructions compared without their addresses). Needs nvcc, cuobjdump and
cu++filt, which only the machine with the card has.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile

from omnifusion_torch.ops._build import NVCC_FLAGS

_CUDA_BIN = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")


def _run(*cmd: str, stdin: str | None = None) -> str:
    proc = subprocess.run(cmd, input=stdin, capture_output=True, text=True, check=True)
    return proc.stdout + proc.stderr


def _demangle(names: list[str]) -> dict[str, str]:
    out = _run(os.path.join(_CUDA_BIN, "cu++filt"), stdin="\n".join(names) + "\n").splitlines()
    return dict(zip(names, out))


def compile_source(path: str) -> dict:
    """{demangled kernel: {registers, spill_stores, spill_loads, smem, sass}}."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        log = _run(os.path.join(_CUDA_BIN, "nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-cubin",
                   "-o", cubin, path)
        sass = _run(os.path.join(_CUDA_BIN, "cuobjdump"), "-sass", cubin)
    kernels: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = kernels.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(m.group(1)) if m else 0
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels.setdefault(name, {})["sass"] = []
        elif name and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)):
            kernels[name]["sass"].append(m.group(1).strip())
    names = _demangle(sorted(kernels))
    return {names[k]: v for k, v in kernels.items()}


def _key(name: str) -> str:
    """A newer kernel's name with its trailing ``false`` template argument
    (``(bool)0`` as cu++filt writes it) left out: the name of the older
    kernel it should equal."""
    return re.sub(r", (false|\(bool\)0)>\(", ">(", name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source")
    ap.add_argument("--against", default=None, help="an older version of the source")
    args = ap.parse_args(argv)
    new = compile_source(args.source)
    report = {"source": args.source, "kernels": {
        k: {f: v.get(f) for f in ("registers", "spill_stores", "spill_loads", "smem")}
        | {"instructions": len(v.get("sass", []))} for k, v in new.items()}}
    if args.against:
        old = compile_source(args.against)
        pairs = {}
        for k, v in new.items():
            o = old.get(_key(k))
            if o is not None:
                pairs[k] = {"same_sass": o.get("sass") == v.get("sass"),
                            "registers": [o.get("registers"), v.get("registers")],
                            "instructions": [len(o.get("sass", [])), len(v.get("sass", []))]}
        report["against"] = args.against
        report["pairs"] = pairs
        report["unpaired_new"] = sorted(k for k in new if k not in pairs)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
