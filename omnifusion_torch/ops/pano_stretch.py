"""Panorama stretch augmentation (kx/ky anisotropic world stretch), NHWC.

The port's counterpart of ``omnifusion_tpu/ops/pano_stretch.py``. Parity:
equi_pers/pano_stretch.py:11-59 — per-pixel resampling coordinates from the
stretched sphere, bilinear sampling with zero padding and
align_corners=True. The coordinate grid is static per (H, W, kx, ky), so it
is precomputed (numpy, float64) as quad tables, and the sampling is the
port's quad blend (ops/quad_blend.py): on a CUDA tensor the blend kernel
(csrc/quad_blend.cu), and in the backward the spread kernel
(csrc/quad_spread.cu), through the transposed tables; on a CPU tensor their
plain versions.

Dtype: the result is the blend's f32 sums rounded once to the image's dtype,
as every blend of the port stores it. The JAX package's XLA path casts the
weights to the image's dtype and sums in it, so the two agree in f32, and a
16-bit result of the port is the nearer to the f32 one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from omnifusion_torch.ops.quad_blend import BlendTables, quad_blend
from omnifusion_torch.projection.spec import build_vjp_tables


def stretch_grid(h: int, w: int, kx: float, ky: float):
    """The stretch's sampling grid, float64 (H, W) each: (gx, gy) in [-1, 1],
    the ``grid`` of ``F.grid_sample(align_corners=True)``."""
    uv = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).astype(np.float64)
    u = ((uv[..., 0] + 0.5) / w - 0.5) * 2 * np.pi
    v = ((uv[..., 1] + 0.5) / h - 0.5) * np.pi
    sin_u, cos_u, tan_v = np.sin(u), np.cos(u), np.tan(v)
    u0 = np.arctan2(sin_u * kx / ky, cos_u)
    with np.errstate(divide="ignore", invalid="ignore"):
        v0 = np.arctan(tan_v * np.sin(u0) / sin_u * ky)
    v0 = np.nan_to_num(v0, nan=0.0)
    return u0 / np.pi, v0 / (np.pi / 2.0)


@functools.lru_cache(maxsize=32)
def _stretch_tables(h: int, w: int, kx: float, ky: float):
    """idx (H*W, 1) int32 top-left corners and w4 (H*W, 1, 4) f32 weights of
    the stretch's bilinear samples."""
    gx, gy = stretch_grid(h, w, kx, ky)

    # grid_sample semantics: align_corners=True, padding_mode='zeros'
    ix = (gx + 1.0) * 0.5 * (w - 1)
    iy = (gy + 1.0) * 0.5 * (h - 1)
    x0 = np.floor(ix).astype(np.int64)
    y0 = np.floor(iy).astype(np.int64)
    fx = ix - x0
    fy = iy - y0
    w_corner = [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx]
    corners = [(y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)]

    # anchor the quad at a clamped in-bounds position and remap each
    # in-bounds corner to its slot relative to the new anchor; outside
    # corners contribute nothing (padding_mode='zeros')
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    w4 = np.zeros((h, w, 4))
    for wc, (yy, xx) in zip(w_corner, corners):
        dy = yy - y0c
        dx = xx - x0c
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        valid = inside & (dy >= 0) & (dy <= 1) & (dx >= 0) & (dx <= 1)
        slot = dy * 2 + dx  # in {0..3} where valid
        for s in range(4):
            w4[..., s] += np.where(valid & (slot == s), wc, 0.0)
    idx = (y0c * w + x0c).reshape(-1, 1)
    return (
        np.asarray(idx, np.int32),
        np.asarray(w4.reshape(-1, 1, 4), np.float32),
    )


@functools.lru_cache(maxsize=32)
def stretch_tables(h: int, w: int, kx: float, ky: float, device: torch.device) -> BlendTables:
    """The stretch's BlendTables on ``device``, with their transposed tables:
    the source and the output are the (H, W) panorama (row stride W)."""
    idx, w4 = _stretch_tables(h, w, kx, ky)
    return BlendTables.create(idx, w4, w, h * w, device, vjp=build_vjp_tables(idx, w4, h * w),
                              out_w=w)


def pano_stretch(img: torch.Tensor, kx: float, ky: float) -> torch.Tensor:
    """Stretch a panorama by kx (x/z plane) and ky: (B, H, W, C) -> same, in
    ``img``'s dtype; differentiable in ``img``."""
    b, h, w, c = img.shape
    tables = stretch_tables(h, w, float(kx), float(ky), img.device)
    out = quad_blend(img.contiguous().reshape(b, h * w, c), tables, channel_last=True,
                     out_dtype=img.dtype)
    return out.reshape(b, h, w, c)
