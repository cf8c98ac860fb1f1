"""The reference's own gnomonic tables, plain numpy in float64.

A frozen copy of the upstream projection geometry (OmniFusion's
``equi_pers/equi2pers_v3.py`` and ``pers2equi_v3.py``): patch centres on
rings of the sphere, tangent-plane screen coordinates, and the two maps.

- ``e2p``: every patch pixel samples the ERP bilinearly, align_corners=True
  with border padding (``F.grid_sample``'s semantics), longitude wrapped
  into [-1, 1]. Returned as four corner indices into the flattened ERP and
  four weights per patch pixel.
- ``p2e``: every ERP pixel blends the bilinear quads of the patches that
  see it, each quad's corners clamped to the patch, weights masked,
  thresholded at 1e-5 and normalised jointly over all patches and
  corners. Returned as dense (N, K) corner indices into the flattened
  patch stack and (N, K, 4) weights, K the most patches any pixel sees.

Nothing here reads a table of the program.
"""

from __future__ import annotations

import numpy as np

# nrows -> (patches per ring, ring latitude in degrees), bottom ring first
RINGS = {
    3: ((3, 4, 3), (-60.0, 0.0, 60.0)),
    4: ((3, 6, 6, 3), (-67.5, -22.5, 22.5, 67.5)),
    5: ((3, 6, 8, 6, 3), (-72.2, -36.1, 0.0, 36.1, 72.2)),
    6: ((3, 8, 12, 12, 8, 3), (-75.2, -45.93, -15.72, 15.72, 45.93, 75.2)),
}


def centers_deg(nrows: int) -> np.ndarray:
    """(P, 2) patch centres (theta in (0, 360), phi in (-90, 90)) degrees."""
    out = []
    for n_cols, phi in zip(*RINGS[nrows]):
        step = 360.0 / n_cols
        out += [(j * step + step / 2.0, phi) for j in range(n_cols)]
    return np.asarray(out, np.float64)


def centers_radians(nrows: int) -> np.ndarray:
    c = centers_deg(nrows)
    return np.stack([(c[:, 0] / 180.0 - 1.0) * np.pi, c[:, 1] / 90.0 * (np.pi / 2.0)], -1)


def centers_normalized(nrows: int) -> np.ndarray:
    c = centers_deg(nrows)
    return np.stack([c[:, 0] / 180.0 - 1.0, c[:, 1] / 90.0], -1)


def _screen(n: int, fov: float, full: float) -> np.ndarray:
    s = np.linspace(0.0, 1.0, n)
    half = np.pi if full == 360.0 else np.pi / 2.0
    return (s * 2.0 - 1.0) * half * (fov / full)


def patch_angles(patch, fov, nrows):
    """(lon, lat) radians of every patch pixel, (P, h, w) each; lon not
    wrapped."""
    h, w = patch
    x = _screen(w, fov[1], 360.0)[None, None, :]
    y = _screen(h, fov[0], 180.0)[None, :, None]
    c = centers_radians(nrows)
    th, ph = c[:, 0][:, None, None], c[:, 1][:, None, None]
    x = np.broadcast_to(x, (len(c), h, w))
    y = np.broadcast_to(y, (len(c), h, w))
    rho = np.sqrt(x * x + y * y)
    cc = np.arctan(rho)
    with np.errstate(invalid="ignore", divide="ignore"):
        lat = np.arcsin(np.clip(np.cos(cc) * np.sin(ph) + y * np.sin(cc) * np.cos(ph) / rho,
                                -1.0, 1.0))
    lon = th + np.arctan2(x * np.sin(cc), rho * np.cos(ph) * np.cos(cc) - y * np.sin(ph) * np.sin(cc))
    centre = rho == 0
    return np.where(centre, th, lon), np.where(centre, ph, lat)


def unit_sphere(patch, fov, nrows) -> np.ndarray:
    """(P, 3, h, w) unit-sphere coordinates of the patch pixels."""
    lon, lat = patch_angles(patch, fov, nrows)
    return np.stack([np.cos(lat) * np.sin(lon), np.cos(lat) * np.cos(lon), np.sin(lat)], 1)


def e2p(erp, patch, fov, nrows):
    """(idx (P*h*w, 4) int64, w (P*h*w, 4) float64): the four corners of
    each patch pixel's bilinear sample in the flattened ERP."""
    H, W = erp
    lon, lat = patch_angles(patch, fov, nrows)
    u = lon / np.pi
    u = np.where(u > 1.0, u - 2.0, u)
    u = np.where(u < -1.0, u + 2.0, u)
    v = lat / (np.pi / 2.0)
    ix = np.clip((u + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    iy = np.clip((v + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0, y0 = np.floor(ix).astype(np.int64), np.floor(iy).astype(np.int64)
    fx, fy = ix - x0, iy - y0
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    idx = np.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], -1)
    w = np.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], -1)
    return idx.reshape(-1, 4), w.reshape(-1, 4)


def p2e(erp, patch, fov, nrows):
    """(idx (H*W, K, 4) int64, w (H*W, K, 4) float64): for every ERP pixel
    the corners, in the flattened patch stack, of the quads of the K
    patches that see it most, and their normalised weights."""
    H, W = erp
    ph, pw = patch
    c = centers_radians(nrows)
    P = len(c)
    th, phc = c[:, 0][:, None, None], c[:, 1][:, None, None]
    lat = np.linspace(-np.pi / 2.0, np.pi / 2.0, H)[None, :, None]
    lon = np.linspace(-np.pi, np.pi, W)[None, None, :]
    dlon = lon - th
    cos_c = np.sin(phc) * np.sin(lat) + np.cos(phc) * np.cos(lat) * np.cos(dlon)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.cos(lat) * np.sin(dlon) / cos_c
        y = (np.cos(phc) * np.sin(lat) - np.sin(phc) * np.cos(lat) * np.cos(dlon)) / cos_c
    xp = (x / (fov[1] / 360.0 * np.pi) + 1.0) * 0.5 * pw
    yp = (y / (fov[0] / 180.0 * (np.pi / 2.0)) + 1.0) * 0.5 * ph
    mask = ((xp > 0) & (xp < pw) & (yp > 0) & (yp < ph) & (cos_c > 0)).astype(np.float64)
    x0 = np.clip(np.floor(np.nan_to_num(xp)), 0, pw - 1).astype(np.int64)
    y0 = np.clip(np.floor(np.nan_to_num(yp)), 0, ph - 1).astype(np.int64)
    x1, y1 = np.clip(x0 + 1, 0, pw - 1), np.clip(y0 + 1, 0, ph - 1)
    with np.errstate(invalid="ignore"):
        w = np.stack([(x1 - xp) * (y1 - yp), (xp - x0) * (y1 - yp),
                      (x1 - xp) * (yp - y0), (xp - x0) * (yp - y0)], -1) * mask[..., None]
    w = np.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)
    w = w * (w > 1e-5)
    base = np.arange(P)[:, None, None] * (ph * pw)
    idx = np.stack([base + y0 * pw + x0, base + y0 * pw + x1,
                    base + y1 * pw + x0, base + y1 * pw + x1], -1)
    n = H * W
    w = w.transpose(1, 2, 0, 3).reshape(n, P, 4)
    idx = idx.transpose(1, 2, 0, 3).reshape(n, P, 4)
    w = w / np.maximum(w.sum(axis=(1, 2), keepdims=True), 1e-12)
    totals = w.sum(-1)
    k = max(int((totals > 0).sum(1).max()), 1)
    order = np.argsort(-totals, axis=1, kind="stable")[:, :k]
    rows = np.arange(n)[:, None]
    idx, w = idx[rows, order], w[rows, order]
    return np.where(w > 0, idx, 0), w
