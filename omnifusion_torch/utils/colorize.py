"""Depth-map colorization for visual logging (parity: util.py:19-38).

A copy of ``omnifusion_tpu/utils/colorize.py``: matplotlib's jet where
matplotlib is importable (imported at the call, never with this module),
the same matplotlib-free jet where it is not."""

from __future__ import annotations

import numpy as np


def colorize(value, vmin=None, vmax=None, cmap: str = "jet") -> np.ndarray:
    """Colorize a single-channel map to an RGB uint8 image.

    value: (H, W) or (H, W, 1) array-like -> (H, W, 3) uint8.
    """
    value = np.asarray(value, dtype=np.float32)
    if value.ndim == 3:
        value = value[..., 0]
    vmin = float(value.min()) if vmin is None else vmin
    vmax = float(value.max()) if vmax is None else vmax
    if vmin != vmax:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0
    try:
        import matplotlib.cm

        rgba = matplotlib.colormaps[cmap](value, bytes=True)
        return rgba[:, :, :3]
    except (ImportError, AttributeError):  # no matplotlib, or one without colormaps
        # matplotlib-free fallback: simple jet approximation
        v = np.clip(value, 0.0, 1.0)
        r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
        return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
