"""On-disk cache for the precomputed projection tables.

The port's counterpart of ``omnifusion_tpu/projection/table_cache.py``. The
tables (spec.py) are pure functions of the ProjectionSpec, built host-side in
float64 — several seconds of host work at the flagship config — so
they are built once per machine: a versioned ``.npz`` per (table kind, spec)
under ``.table_cache_torch/``.

The port keeps a directory of its own. Its tables hold other arrays than
the JAX package's (CSR tail pointers, no transposed backward tables), and a
shared directory would let one package load the other's tables, so that a
test comparing the two packages' tables would compare one with itself.

Safety rules:

- the key is ``sha256(repr((VERSION, kind, spec)))`` — ProjectionSpec is
  a frozen dataclass of scalars, so its repr is deterministic and total.
  **Bump VERSION whenever the tables a spec yields change.**
- writes are atomic (tempfile + os.replace); loads validate the spec echo
  stored in the file and fall back to a rebuild on any read error.
- arrays are stored bit for bit (uncompressed savez), so a cached load equals
  a fresh build.

Env:
  OMNIFUSION_TORCH_TABLE_CACHE=<dir>  cache directory
                                      (default <repo>/.table_cache_torch)
  OMNIFUSION_TORCH_TABLE_CACHE=0      disable (every process rebuilds)
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile

import numpy as np

VERSION = 1

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str | None:
    d = os.environ.get("OMNIFUSION_TORCH_TABLE_CACHE")
    if d is not None:
        return None if d in ("", "0") else d
    return os.path.join(_REPO, ".table_cache_torch")


def _path(kind: str, spec) -> str | None:
    d = cache_dir()
    if d is None:
        return None
    key = hashlib.sha256(repr((VERSION, kind, spec)).encode()).hexdigest()[:24]
    return os.path.join(d, f"{kind}-{key}.npz")


def load(kind: str, spec) -> dict[str, np.ndarray] | None:
    """Arrays for (kind, spec), or None on a miss, when disabled, or when
    the file cannot be read."""
    path = _path(kind, spec)
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["__spec__"]) != repr(spec):  # hash collision / stale key
                return None
            return {k: np.array(z[k]) for k in z.files if k != "__spec__"}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None  # torn or corrupt file: the caller rebuilds and overwrites


def save(kind: str, spec, arrays: dict[str, np.ndarray]) -> None:
    """Atomically persist arrays for (kind, spec); best effort."""
    path = _path(kind, spec)
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __spec__=repr(spec), **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError:
        pass  # read-only or full disk: the lru_cache still covers this process
