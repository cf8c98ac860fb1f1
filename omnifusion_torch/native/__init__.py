"""Native (C++) host-side components with ctypes bindings.

The port's counterpart of ``omnifusion_tpu/native/``: a minimal OpenEXR
scanline reader (``exr_reader.cpp``, the port's own copy) that the 360D
dataset reads its depth with. The shared library is compiled with g++ on
first use into ``omnifusion_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, never next to the source. The build writes a
temporary file and renames it into place, so processes that build at once
(test workers) each load a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "exr_reader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Path of the reader's shared library, compiled if it is not built yet."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libexr_reader_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", _SRC, "-o", tmp, "-lz"],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.exr_read_channel.restype = ctypes.c_int
            lib.exr_read_channel.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
    return _lib


_ERRORS = {
    1: "cannot open file",
    2: "cannot read file",
    3: "bad EXR header (no data window, or a tiled/multi-part file)",
    4: "unsupported compression (only NONE/ZIPS/ZIP)",
    5: "channel not found",
    6: "corrupt chunk table or chunk",
    7: "zlib inflate failed",
}


def read_exr_channel(path: str, channel: str = "R") -> np.ndarray:
    """Read one channel of a scanline EXR file -> float32 (H, W)."""
    lib = _get_lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.exr_read_channel(path.encode(), channel.encode(), None, w, h)
    if rc != 0:
        raise RuntimeError(f"EXR read {path!r}: {_ERRORS.get(rc, rc)}")
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.exr_read_channel(
        path.encode(),
        channel.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w,
        h,
    )
    if rc != 0:
        raise RuntimeError(f"EXR read {path!r}: {_ERRORS.get(rc, rc)}")
    return out
