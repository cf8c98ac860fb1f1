"""Build and load the port's CUDA kernels.

Every ``.cu`` file under ``omnifusion_torch/csrc/`` is compiled by ONE
``nvcc`` call into one shared library with a plain C interface, which is
loaded with ctypes. Nothing includes PyTorch's headers, so the build takes
seconds. The library lands in ``omnifusion_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, at first use in a
process; a later process with the same sources loads it without building.

Pointers and the stream go through ctypes as ``c_void_p``, sizes and strides
as ``c_int64``. Every entry returns ``cudaGetLastError()`` of its launch;
the wrappers in ``quad_blend.py`` and ``upsample.py`` raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# the kernels' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "omnifusion_quad_blend": (
        _P, _I, _P, _P, _P, _I, _P, _P, _P,  # src, dtype, out, idx, w4, k, tail ptr/idx/w
        _L, _L, _L, _L, _L,  # n_rows, channels, n_in, n_out, row_stride
        _L, _L, _L, _L, _L, _L,  # src strides (b, c, pixel), out strides
        _P,  # stream
    ),
    "omnifusion_up2x": (_P, _P, _I, _L, _L, _L, _P),
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
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        cu = [s for s in sources() if s.endswith(".cu")]
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
