"""Build and load the port's CUDA kernels.

Every ``.cu`` file under ``omnifusion_torch/csrc/`` is compiled by its own
``nvcc`` call, all started together, and one more ``nvcc`` call links the
objects into one shared library with a plain C interface, which is loaded
with ctypes. Nothing includes PyTorch's headers, so the build takes seconds.
The library lands in ``omnifusion_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, at first use in a
process; a later process with the same sources loads it without building.

Pointers and the stream go through ctypes as ``c_void_p``, sizes and strides
as ``c_int64``. Every entry returns ``cudaGetLastError()`` of its launch;
the wrappers in ``quad_blend.py``, ``upsample.py``, ``heads.py``,
``epilogue.py`` and ``probe.py`` raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import torch

from omnifusion_torch.utils.profiling import count, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# the kernels' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "omnifusion_quad_blend": (
        _P, _I, _P, _I,  # src, dtype, out, out dtype
        _P, _P, _P, _I,  # w4, corner offsets, idx, k
        _P, _P, _P, _P,  # tail ptr, w, offsets, idx
        _P, _P, _L, _I, _I, _I, _I,  # footprints (ptr, groups), n_tiles, tiles_x, tile h, w, pitch
        _L, _L, _I,  # n_units, units per block (grid.y), elements per pixel
        _L, _L, _L, _L,  # n_in, n_out, row_stride, out_w
        _I, _I, _I,  # entries, chunk, staged
        _P,  # stream
    ),
    "omnifusion_quad_spread": (
        _P, _I, _P, _P, _P, _I, _P, _P, _P,  # cot, dtype, out, idx_t, w_t, k_t, over ptr/src/w
        _I, _P, _L, _L,  # threshold, heavy, n_heavy, n_wide
        _L, _L, _L, _L, _L,  # n_rows, channels, n_cot, n_in, row_stride
        _L, _L, _L, _L, _L, _L,  # cot strides (b, c, pixel), out strides
        _P,  # stream
    ),
    "omnifusion_up2x": (_P, _P, _I, _L, _L, _L, _P),
    "omnifusion_up2x_adjoint": (_P, _P, _I, _L, _L, _L, _P),
    "omnifusion_up2x_nhwc": (_P, _P, _I, _L, _L, _L, _L, _P),  # x, y, dtype, n, h, w, c, stream
    "omnifusion_probe": (_P, _P, _L, _P),  # x, out, n, stream
    "omnifusion_fused_heads": (
        _P, _I, _P, _P, _P, _P,  # x, dtype, pred weight, bias, conf weight, bias
        _P, _P, _I, _L, _L, _L, _I,  # pred, conf, outputs, rows, h, w, relu
        _P,  # stream
    ),
    # y, z, dtype, scale, bias, z scale, z bias, n, c, hw, nhwc, stream
    "omnifusion_conv_epilogue": (_P, _P, _I, _P, _P, _P, _P, _L, _L, _L, _I, _P),
}


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libomnifusion_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path. Raises with nvcc's output when the build fails."""
    path = _library_path()
    if os.path.exists(path):
        return path
    count("kernel_library.built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        cu = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp_dir, os.path.basename(s) + ".o") for s in cu]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(cu, objs)
        ]
        failed = []
        for s, proc in zip(cu, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(s)} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp_dir, "lib.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, path)  # atomic: a concurrent loader sees all or nothing
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (the span
    ``kernel_library``; the counter ``kernel_library.built`` when nvcc
    runs)."""
    with span("kernel_library"):
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return lib


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """Where a wrapper runs: True on a CUDA tensor (its kernel), False on a
    CPU tensor (its plain version); raises on any other device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {x.device}")
    return x.device.type == "cuda"


def channels_last(x: torch.Tensor) -> bool:
    """True where ``x`` is a 4-d tensor with channels-last strides and not
    contiguous ones: the input of the kernels' channel-last forms. A map
    that is both (one pixel, or one channel) counts as contiguous."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
