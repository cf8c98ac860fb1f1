"""Arbitrary perspective-view extraction from panoramas, and its inverse.

The port's counterpart of ``omnifusion_tpu/projection/perspective.py``:
true pinhole views at arbitrary (theta, phi) centers with tan-scaled image
planes (w_len = tan(fov/2), equi2pers_torch.py:51-52 upstream), and their
projection back onto the panorama. Each is one static sparse gather-blend
(ops/quad_blend.py): on a CUDA tensor the blend kernel, on a CPU tensor its
plain version; both are differentiable in their input through the
transposed tables (``quad_spread`` on the card). The tables are built in
numpy, float64, and cached per (centers, fov, size, ERP size, device).

Unlike the tangent patches of the main path, whose screen coordinates are
angle-linear, these image planes are tan-spaced; and insert_views writes one
ERP per view, so its output rows are V ERPs stacked.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from omnifusion_torch.geometry import gnomonic
from omnifusion_torch.ops.quad_blend import BlendTables, quad_blend
from omnifusion_torch.projection.spec import _fold_clamped_corners, build_vjp_tables


def _bilinear(ix: np.ndarray, iy: np.ndarray, x_max: int, y_max: int):
    """Top-left corners and folded quad weights of clamped sample points."""
    x0 = np.floor(ix).astype(np.int64)
    y0 = np.floor(iy).astype(np.int64)
    fx = ix - x0
    fy = iy - y0
    w4 = np.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], -1)
    return x0, y0, w4, x0 + 1 > x_max, y0 + 1 > y_max


def perspective_arrays(centers_deg: tuple, fov_deg: tuple, size: tuple, erp_size: tuple):
    """extract_views' tables in numpy: idx (V*h*w, 1) int32 into the ERP's
    pixels and w4 (V*h*w, 1, 4) f32."""
    h, w = size
    erp_h, erp_w = erp_size
    fov_h, fov_w = fov_deg

    # true pinhole image plane: tan-scaled tangent coords
    x = np.linspace(-1.0, 1.0, w) * np.tan(np.radians(fov_w) / 2.0)
    y = np.linspace(-1.0, 1.0, h) * np.tan(np.radians(fov_h) / 2.0)
    X = np.broadcast_to(x[None, None, :], (len(centers_deg), h, w))
    Y = np.broadcast_to(y[None, :, None], (len(centers_deg), h, w))

    centers = np.asarray(centers_deg, np.float64)
    # theta = 0 deg is the ERP's left edge (lon = -pi), the patch-center
    # convention of the main projections (geometry/layout.py)
    theta_c = (np.radians(centers[:, 0]) - np.pi)[:, None, None]
    phi_c = np.radians(centers[:, 1])[:, None, None]
    lon, lat = gnomonic.forward(X, Y, theta_c, phi_c)

    lon_n = np.mod(lon / np.pi + 1.0, 2.0) - 1.0  # wrap to [-1, 1)
    lat_n = lat / (np.pi / 2.0)
    ix = np.clip((lon_n + 1.0) * 0.5 * (erp_w - 1), 0.0, erp_w - 1)
    iy = np.clip((lat_n + 1.0) * 0.5 * (erp_h - 1), 0.0, erp_h - 1)
    x0, y0, w4, x_cl, y_cl = _bilinear(ix, iy, erp_w - 1, erp_h - 1)
    w4 = _fold_clamped_corners(w4, x_cl, y_cl)
    idx = (y0 * erp_w + x0).reshape(-1, 1).astype(np.int32)
    return idx, w4.reshape(-1, 1, 4).astype(np.float32)


def inverse_perspective_arrays(centers_deg: tuple, fov_deg: tuple, size: tuple,
                               erp_size: tuple):
    """insert_views' tables in numpy: idx (V*H*W, 1) int32 into the V
    views' pixels, w4 (V*H*W, 1, 4) f32, and the visibility mask (V, H, W)
    f32."""
    h, w = size
    erp_h, erp_w = erp_size
    fov_h, fov_w = fov_deg
    n_views = len(centers_deg)

    # the reference samples the ERP grid with pixel CENTERS spanning the full
    # angle range via linspace (pers2equi_torch.py:42), matching the
    # align_corners grids elsewhere
    lat = np.linspace(-np.pi / 2.0, np.pi / 2.0, erp_h)[None, :, None]
    lon = np.linspace(-np.pi, np.pi, erp_w)[None, None, :]
    centers = np.asarray(centers_deg, np.float64)
    theta_c = (np.radians(centers[:, 0]) - np.pi)[:, None, None]
    phi_c = np.radians(centers[:, 1])[:, None, None]
    x, y, cos_c = gnomonic.inverse(
        np.broadcast_to(lon, (n_views, erp_h, erp_w)),
        np.broadcast_to(lat, (n_views, erp_h, erp_w)),
        theta_c,
        phi_c,
    )
    # tan image plane (true pinhole): visible iff in front of the camera and
    # inside the tan-scaled bounds (pers2equi_torch.py:64-71)
    w_len = np.tan(np.radians(fov_w) / 2.0)
    h_len = np.tan(np.radians(fov_h) / 2.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        mask = (cos_c > 0) & (np.abs(x) < w_len) & (np.abs(y) < h_len)
        ix = np.clip((x / w_len + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
        iy = np.clip((y / h_len + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    x0, y0, w4, x_cl, y_cl = _bilinear(np.nan_to_num(ix), np.nan_to_num(iy), w - 1, h - 1)
    w4 = _fold_clamped_corners(w4 * mask[..., None], x_cl, y_cl)
    base = (np.arange(n_views, dtype=np.int64) * (h * w))[:, None, None]
    idx = (base + y0 * w + x0).reshape(-1, 1).astype(np.int32)
    return idx, w4.reshape(-1, 1, 4).astype(np.float32), mask.astype(np.float32)


def _tables(idx, w4, row_stride: int, n_in: int, out_w: int, device) -> BlendTables:
    return BlendTables.create(idx, w4, row_stride, n_in, device,
                              vjp=build_vjp_tables(idx, w4, n_in), out_w=out_w)


@functools.lru_cache(maxsize=64)
def perspective_tables(centers_deg: tuple, fov_deg: tuple, size: tuple, erp_size: tuple,
                       device: torch.device) -> BlendTables:
    """extract_views' BlendTables on ``device``: the source is the ERP (row
    stride W), the output V views of ``size``."""
    idx, w4 = perspective_arrays(centers_deg, fov_deg, size, erp_size)
    return _tables(idx, w4, erp_size[1], erp_size[0] * erp_size[1], size[1], device)


@functools.lru_cache(maxsize=64)
def inverse_perspective_tables(centers_deg: tuple, fov_deg: tuple, size: tuple,
                               erp_size: tuple, device: torch.device):
    """insert_views' (BlendTables, mask (V, H, W, 1) f32) on ``device``: the
    source is the V views (row stride w), the output V ERPs."""
    idx, w4, mask = inverse_perspective_arrays(centers_deg, fov_deg, size, erp_size)
    tables = _tables(idx, w4, size[1], len(centers_deg) * size[0] * size[1], erp_size[1], device)
    return tables, torch.from_numpy(mask)[..., None].to(device)


def _key(centers_deg, fov):
    centers = tuple(tuple(float(v) for v in ct) for ct in centers_deg)
    fov_t = (float(fov[0]), float(fov[1])) if isinstance(fov, (tuple, list)) else (float(fov),) * 2
    return centers, fov_t


def extract_views(erp: torch.Tensor, centers_deg, fov=(90.0, 90.0), size=(256, 256)):
    """Extract pinhole views at arbitrary sphere directions.

    Port of util.transform_equi (util.py:40-50 upstream), with the view axis
    first-class. erp: (B, H, W, C); centers_deg: a sequence of (theta, phi)
    in degrees with theta in [0, 360) and phi in (-90, 90); fov, size: per
    view. Returns (B, V, h, w, C) in erp's dtype (the blend's f32 sums
    rounded once)."""
    b, h, w, c = erp.shape
    centers, fov_t = _key(centers_deg, fov)
    size_t = (int(size[0]), int(size[1]))
    tables = perspective_tables(centers, fov_t, size_t, (h, w), erp.device)
    out = quad_blend(erp.contiguous().reshape(b, h * w, c), tables, channel_last=True,
                     out_dtype=erp.dtype)
    return out.reshape(b, len(centers), size_t[0], size_t[1], c)


def insert_views(views: torch.Tensor, centers_deg, fov=(90.0, 90.0), erp_size=(512, 1024)):
    """Project pinhole views back onto the panorama, one ERP per view.

    Port of util.transform_pers (util.py:53-60 upstream): bilinear resample
    of each view onto the sphere, zeros outside the view frustum, plus the
    visibility mask. views: (B, V, h, w, C) as extract_views returns them
    with the same centers and fov. Returns (equi (B, V, H, W, C) in views'
    dtype, mask (V, H, W, 1) f32)."""
    b, v, h, w, c = views.shape
    centers, fov_t = _key(centers_deg, fov)
    erp_t = (int(erp_size[0]), int(erp_size[1]))
    tables, mask = inverse_perspective_tables(centers, fov_t, (h, w), erp_t, views.device)
    out = quad_blend(views.contiguous().reshape(b, v * h * w, c), tables, channel_last=True,
                     out_dtype=views.dtype)
    return out.reshape(b, v, erp_t[0], erp_t[1], c), mask
