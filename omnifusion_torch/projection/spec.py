"""Projection configuration and precomputed static tables.

The port's counterpart of ``omnifusion_tpu/projection/spec.py``. Both
directions of the gnomonic tangent-patch projection are static sparse linear
maps over pixels: every output pixel is a fixed weighted sum of the 2x2
bilinear quads of at most K input pixels. The tables are built once per
config on the host in float64, with the same arithmetic as the JAX package's,
so that they are equal array for array (tests/test_torch_port_tables.py).

Differences from the JAX module:

- the tables are plain dataclasses of numpy arrays (no flax.struct);
- the capped merge table carries CSR row pointers over its sorted COO tail
  (``tail_ptr``), so the gather-blend kernel walks each output pixel's tail
  segment without atomics;
- the transposed backward tables (``TransposedTables``) carry CSR row
  pointers over their overflow, sorted by destination (``over_ptr``), so
  the transposed kernel walks each source pixel's overflow the same way.

``build_equi2pers_grids`` and ``build_pers2equi_grids`` keep one set of
tables per spec in the process; where they build one, they open the span
``tables`` and count ``tables.computed`` or ``tables.from_disk``
(utils/profiling.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from omnifusion_torch.geometry import gnomonic
from omnifusion_torch.geometry.layout import num_patches, patch_centers, uniform_patch_centers
from omnifusion_torch.projection import table_cache
from omnifusion_torch.utils.profiling import count, span


def _pair(t):
    return tuple(t) if isinstance(t, (tuple, list)) else (t, t)


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """Static configuration of the tangent-patch projection pair.

    Same fields, defaults, layouts and repr as the JAX package's
    ProjectionSpec (the repr keys the table cache): ``layout`` is "rings"
    (equi2pers_v3, ``nrows`` rows of patches) or "uniform:RxC" (the v2 grid
    of R rows by C columns; ``nrows`` is not read). As in the JAX spec, a
    layout that does not start with "uniform" is the rings layout."""

    erp_h: int
    erp_w: int
    patch_h: int
    patch_w: int
    fov_h: float
    fov_w: float
    nrows: int
    layout: str = "rings"  # "rings" (equi2pers_v3) or "uniform:RxC" (v2)

    def __post_init__(self):
        # the JAX spec fails on these at its first table; refuse them here
        if self.layout.startswith("uniform"):
            try:
                rows, cols = self._uniform_shape()
            except (IndexError, ValueError):
                raise ValueError(f"a uniform layout is 'uniform:RxC', got {self.layout!r}") from None
            if rows < 1 or cols < 1:
                raise ValueError(f"a uniform layout needs a row and a column, got {self.layout!r}")

    @classmethod
    def create(
        cls, erp_size, patch_size, fov=(80, 80), nrows: int = 4, layout: str = "rings"
    ) -> "ProjectionSpec":
        erp_h, erp_w = _pair(erp_size)
        patch_h, patch_w = _pair(patch_size)
        fov_h, fov_w = _pair(fov)
        return cls(
            erp_h=int(erp_h),
            erp_w=int(erp_w),
            patch_h=int(patch_h),
            patch_w=int(patch_w),
            fov_h=float(fov_h),
            fov_w=float(fov_w),
            nrows=int(nrows),
            layout=str(layout),
        )

    def _uniform_shape(self):
        rows, cols = self.layout.split(":", 1)[1].split("x")
        return int(rows), int(cols)

    @property
    def n_patches(self) -> int:
        if self.layout.startswith("uniform"):
            r, c = self._uniform_shape()
            return r * c
        return num_patches(self.nrows)

    def centers_deg(self) -> np.ndarray:
        """Patch centers in degrees (theta in (0,360), phi in (-90,90))."""
        if self.layout.startswith("uniform"):
            return uniform_patch_centers(*self._uniform_shape())
        return patch_centers(self.nrows)

    def centers_radians(self) -> np.ndarray:
        c = self.centers_deg()
        out = np.empty_like(c)
        out[:, 0] = (c[:, 0] / 180.0 - 1.0) * np.pi
        out[:, 1] = c[:, 1] / 90.0 * (np.pi / 2.0)
        return out

    def centers_normalized(self) -> np.ndarray:
        c = self.centers_deg()
        out = np.empty_like(c)
        out[:, 0] = c[:, 0] / 180.0 - 1.0
        out[:, 1] = c[:, 1] / 90.0
        return out

    def with_patch_scale(self, denom: int) -> "ProjectionSpec":
        """Same spec at a reduced patch resolution (e.g. /4 for geometry feats)."""
        return dataclasses.replace(
            self, patch_h=self.patch_h // denom, patch_w=self.patch_w // denom
        )


@dataclasses.dataclass(frozen=True, eq=False)
class TransposedTables:
    """The transpose of a quad map, for the backward (build_vjp_tables).

    Keyed by the forward's source pixel j (the top-left corner of a quad):
    up to K_T (output pixel, 4 corner weights) entries in ``idx_t``/``w_t``,
    the rest in a COO overflow sorted by ``over_dst`` with CSR row pointers
    ``over_ptr`` (N_in + 1): the overflow of source pixel j is
    ``over_ptr[j]:over_ptr[j+1]``."""

    idx_t: np.ndarray  # (N_in, K_T) int32 output pixels (0 where w_t is 0)
    w_t: np.ndarray  # (N_in, K_T, 4) float32 corner weights [00, 01, 10, 11]
    over_src: np.ndarray  # (M,) int32 output pixel of each overflow quad
    over_dst: np.ndarray  # (M,) int32 sorted source pixel (top-left corner)
    over_w: np.ndarray  # (M, 4) float32
    over_ptr: np.ndarray  # (N_in + 1,) int32


@dataclasses.dataclass(frozen=True, eq=False)
class Equi2PersGrids:
    """Static tables for ERP -> tangent patches.

    idx/w4 implement bilinear sampling with border padding and
    align_corners=True semantics (F.grid_sample parity) in quad form: one
    2x2 neighbourhood per output pixel, border-clamped corner weights folded
    into the surviving corner.
    """

    idx: np.ndarray  # (P*h*w, 1) int32 top-left corner into erp_h*erp_w
    w4: np.ndarray  # (P*h*w, 1, 4) float32 quad weights [00, 01, 10, 11]
    xyz: np.ndarray  # (P, h, w, 3) unit-sphere coords per patch pixel
    uv: np.ndarray  # (P, h, w, 2) normalized (lon, lat) in [-1, 1]
    centers: np.ndarray  # (P, 2) normalized patch centers in [-1, 1]
    vjp: TransposedTables
    spec: ProjectionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class CappedTables:
    """The merge map re-packed as a dense cap plus a sorted COO tail.

    ``tail_ptr`` (N_out+1) holds CSR row pointers over ``tail_pix``: the
    tail entries of output pixel n are ``tail_ptr[n]:tail_ptr[n+1]``."""

    idx: np.ndarray  # (N_out, CAP) int32 top-left corners, live-first per pixel
    w4: np.ndarray  # (N_out, CAP, 4) float32
    tail_pix: np.ndarray  # (M,) int32 sorted output pixel of each tail quad
    tail_idx: np.ndarray  # (M,) int32 top-left corner of each tail quad
    tail_w: np.ndarray  # (M, 4) float32
    tail_ptr: np.ndarray  # (N_out + 1,) int32


@dataclasses.dataclass(frozen=True, eq=False)
class Pers2EquiGrids:
    """Static tables for tangent patches -> ERP (confidence-style blending).

    Per ERP pixel: the top-left corner index of a bilinear quad in each of
    the <=K contributing patches, plus pre-normalized quad weights (sum over
    K*4 is 1 wherever any patch covers the pixel, 0 elsewhere). ``capped``
    is the same map as a dense cap plus a sorted COO tail, or None when the
    dense table is already tight (see build_capped_tables).
    """

    idx: np.ndarray  # (erp_h*erp_w, K) int32 into P*h*w
    w4: np.ndarray  # (erp_h*erp_w, K, 4) float32 [00, 01, 10, 11]
    capped: CappedTables | None
    vjp: TransposedTables
    spec: ProjectionSpec


# ---------------------------------------------------------------------------
# table construction (host-side, float64, run once per spec)
# ---------------------------------------------------------------------------


def _forward_angles(spec: ProjectionSpec):
    """(lon, lat) radians per patch pixel, shape (P, h, w) each.

    lon is unwrapped (can exceed +-pi); used both for sampling coords and for
    the xyz/uv geometric features.
    """
    h, w = spec.patch_h, spec.patch_w
    sx = np.linspace(0.0, 1.0, w)
    sy = np.linspace(0.0, 1.0, h)
    x = gnomonic.screen_to_tangent(sx, spec.fov_w, 360.0)[None, None, :]  # (1,1,w)
    y = gnomonic.screen_to_tangent(sy, spec.fov_h, 180.0)[None, :, None]  # (1,h,1)
    centers = spec.centers_radians()  # (P, 2)
    theta_c = centers[:, 0][:, None, None]
    phi_c = centers[:, 1][:, None, None]
    return gnomonic.forward(
        np.broadcast_to(x, (spec.n_patches, h, w)),
        np.broadcast_to(y, (spec.n_patches, h, w)),
        theta_c,
        phi_c,
    )


def _fold_clamped_corners(w4: np.ndarray, x_clamped: np.ndarray, y_clamped: np.ndarray) -> np.ndarray:
    """Fold the weights of border-clamped bilinear corners into the
    coincident surviving corner (x1==x0 and/or y1==y0 after clamping).

    The corners that lose their weight may point past a row, a patch or the
    whole source; the blend reads them modulo N_in with weight 0.
    w4 order: [w00, w01, w10, w11]; x_clamped/y_clamped broadcast to w4[..., 0].
    """
    w00, w01, w10, w11 = (w4[..., i] for i in range(4))
    w00 = w00 + np.where(x_clamped, w01, 0.0)
    w10 = w10 + np.where(x_clamped, w11, 0.0)
    w01 = np.where(x_clamped, 0.0, w01)
    w11 = np.where(x_clamped, 0.0, w11)
    w00 = w00 + np.where(y_clamped, w10, 0.0)
    w01 = w01 + np.where(y_clamped, w11, 0.0)
    w10 = np.where(y_clamped, 0.0, w10)
    w11 = np.where(y_clamped, 0.0, w11)
    return np.stack([w00, w01, w10, w11], axis=-1)


# The JAX package's cost model of a sparse table: a dense slot costs one
# gather per pixel, an overflow or tail entry _SCATTER_COST of them. Both
# packages must cut their tables at the same place, so it is fixed here, as
# is the largest dense fan-in of a transposed table (the JAX default cap).
_SCATTER_COST = 3.0
_MAX_K_T = 16


def build_vjp_tables(idx: np.ndarray, w4: np.ndarray, n_in: int) -> TransposedTables:
    """Transpose a quad table (N_out, K) for the backward, in quad
    granularity: one entry per (source quad, output pixel) with the 4
    corner weights attached; the corner split is recovered when the
    transposed map is applied (ops/quad_blend.py: quad_spread).

    The dense fan-in K_T <= _MAX_K_T minimizes
    ``n_in*k + _SCATTER_COST*overflow(k)``; the rest of each source pixel's
    fan-in goes to a COO overflow sorted by destination (the border pixels
    of the pole patches, which absorb clamp-folded weights, have fan-ins
    near 1000)."""
    n_out, k = idx.shape
    j = idx.astype(np.int64).reshape(-1)
    w = np.asarray(w4, np.float64).reshape(-1, 4)
    n = np.repeat(np.arange(n_out, dtype=np.int64), k)
    keep = w.sum(-1) > 0
    j, w, n = j[keep], w[keep], n[keep]
    order = np.argsort(j, kind="stable")
    j, w, n = j[order], w[order], n[order]

    counts = np.bincount(j, minlength=n_in)
    k_t = 1
    if len(j):
        hi = int(min(counts.max(), _MAX_K_T))
        costs = [
            n_in * c + _SCATTER_COST * np.maximum(counts - c, 0).sum()
            for c in range(1, hi + 1)
        ]
        k_t = int(np.argmin(costs)) + 1
    rank = np.arange(len(j)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    in_table = rank < k_t
    idx_t = np.zeros((n_in, k_t), np.int32)
    w_t = np.zeros((n_in, k_t, 4), np.float32)
    idx_t[j[in_table], rank[in_table]] = n[in_table]
    w_t[j[in_table], rank[in_table]] = w[in_table]

    over = ~in_table
    over_dst = j[over]
    return TransposedTables(
        idx_t=idx_t,
        w_t=w_t,
        over_src=n[over].astype(np.int32),
        over_dst=over_dst.astype(np.int32),
        over_w=w[over].astype(np.float32),
        over_ptr=np.concatenate(
            [[0], np.cumsum(np.bincount(over_dst, minlength=n_in))]
        ).astype(np.int32),
    )


_VJP_KEYS = tuple(f.name for f in dataclasses.fields(TransposedTables))


def _vjp_arrays(t: TransposedTables) -> dict:
    return {f"vjp_{k}": getattr(t, k) for k in _VJP_KEYS}


def _vjp_from(cached: dict) -> TransposedTables:
    return TransposedTables(**{k: cached.pop(f"vjp_{k}") for k in _VJP_KEYS})


@functools.lru_cache(maxsize=None)
def build_equi2pers_grids(spec: ProjectionSpec) -> Equi2PersGrids:
    with span("tables"):
        cached = table_cache.load("e2p", spec)
        if cached is not None:
            count("tables.from_disk")
            vjp = _vjp_from(cached)  # takes the vjp_* arrays out of ``cached``
            return Equi2PersGrids(vjp=vjp, spec=spec, **cached)
        count("tables.computed")
        g = _build_equi2pers_grids(spec)
        table_cache.save(
            "e2p", spec,
            dict(idx=g.idx, w4=g.w4, xyz=g.xyz, uv=g.uv, centers=g.centers, **_vjp_arrays(g.vjp)),
        )
        return g


def _build_equi2pers_grids(spec: ProjectionSpec) -> Equi2PersGrids:
    lon, lat = _forward_angles(spec)
    lon_n = lon / np.pi
    lat_n = lat / (np.pi / 2.0)
    # longitude wraparound into [-1, 1] (equi2pers_v3.py:103-104)
    lon_n = np.where(lon_n > 1.0, lon_n - 2.0, lon_n)
    lon_n = np.where(lon_n < -1.0, lon_n + 2.0, lon_n)

    # align_corners=True unnormalization + border padding (clamp)
    ix = np.clip((lon_n + 1.0) * 0.5 * (spec.erp_w - 1), 0.0, spec.erp_w - 1)
    iy = np.clip((lat_n + 1.0) * 0.5 * (spec.erp_h - 1), 0.0, spec.erp_h - 1)

    x0 = np.floor(ix).astype(np.int64)
    y0 = np.floor(iy).astype(np.int64)
    fx = ix - x0
    fy = iy - y0

    w4 = np.stack(
        [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], axis=-1
    )
    w4 = _fold_clamped_corners(
        w4, x0 + 1 > spec.erp_w - 1, y0 + 1 > spec.erp_h - 1
    )
    idx = (y0 * spec.erp_w + x0).reshape(-1, 1)
    w4 = w4.reshape(-1, 1, 4)

    cos_lat = np.cos(lat)
    xyz = np.stack(
        [cos_lat * np.sin(lon), cos_lat * np.cos(lon), np.sin(lat)], axis=-1
    )
    uv = np.stack([lon_n, lat_n], axis=-1)
    idx = np.asarray(idx, dtype=np.int32)
    w4 = np.asarray(w4, dtype=np.float32)
    return Equi2PersGrids(
        idx=idx,
        w4=w4,
        xyz=np.asarray(xyz, dtype=np.float32),
        uv=np.asarray(uv, dtype=np.float32),
        centers=np.asarray(spec.centers_normalized(), dtype=np.float32),
        vjp=build_vjp_tables(idx, w4, spec.erp_h * spec.erp_w),
        spec=spec,
    )


_CAPPED_KEYS = ("idx", "w4", "tail_pix", "tail_idx", "tail_w", "tail_ptr")


@functools.lru_cache(maxsize=None)
def build_pers2equi_grids(spec: ProjectionSpec) -> Pers2EquiGrids:
    with span("tables"):
        cached = table_cache.load("p2e", spec)
        if cached is not None:
            count("tables.from_disk")
            capped = (
                CappedTables(**{k: cached[f"cap_{k}"] for k in _CAPPED_KEYS})
                if "cap_idx" in cached
                else None
            )
            return Pers2EquiGrids(
                idx=cached["idx"], w4=cached["w4"], capped=capped, vjp=_vjp_from(cached),
                spec=spec,
            )
        count("tables.computed")
        g = _build_pers2equi_grids(spec)
        arrays = dict(idx=g.idx, w4=g.w4, **_vjp_arrays(g.vjp))
        if g.capped is not None:
            arrays.update({f"cap_{k}": getattr(g.capped, k) for k in _CAPPED_KEYS})
        table_cache.save("p2e", spec, arrays)
        return g


def _build_pers2equi_grids(spec: ProjectionSpec) -> Pers2EquiGrids:
    P = spec.n_patches
    ph, pw = spec.patch_h, spec.patch_w
    erp_h, erp_w = spec.erp_h, spec.erp_w

    lat = np.linspace(-np.pi / 2.0, np.pi / 2.0, erp_h)[None, :, None]
    lon = np.linspace(-np.pi, np.pi, erp_w)[None, None, :]
    centers = spec.centers_radians()
    theta_c = centers[:, 0][:, None, None]
    phi_c = centers[:, 1][:, None, None]

    x, y, cos_c = gnomonic.inverse(
        np.broadcast_to(lon, (P, erp_h, erp_w)),
        np.broadcast_to(lat, (P, erp_h, erp_w)),
        theta_c,
        phi_c,
    )
    x_n = x / (spec.fov_w / 360.0 * np.pi)
    y_n = y / (spec.fov_h / 180.0 * (np.pi / 2.0))
    # pixel coords in [0, pw] x [0, ph], each axis scaled by its own size
    x_pix = (x_n + 1.0) * 0.5 * pw
    y_pix = (y_n + 1.0) * 0.5 * ph

    mask = (
        (x_pix > 0) & (x_pix < pw) & (y_pix > 0) & (y_pix < ph) & (cos_c > 0)
    ).astype(np.float64)

    x0 = np.clip(np.floor(x_pix), 0, pw - 1).astype(np.int64)
    x1 = np.clip(x0 + 1, 0, pw - 1)
    y0 = np.clip(np.floor(y_pix), 0, ph - 1).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, ph - 1)

    # bilinear corner weights from the *clamped* corners, then masked and
    # thresholded (pers2equi_v3.py:139-152,191).
    # Quad order [00, 01, 10, 11] = [(y0,x0), (y0,x1), (y1,x0), (y1,x1)].
    with np.errstate(invalid="ignore"):
        w00 = (x1 - x_pix) * (y1 - y_pix) * mask
        w01 = (x_pix - x0) * (y1 - y_pix) * mask
        w10 = (x1 - x_pix) * (y_pix - y0) * mask
        w11 = (x_pix - x0) * (y_pix - y0) * mask
    w_all = np.stack([w00, w01, w10, w11], axis=-1)  # (P, H, W, 4)
    w_all = np.nan_to_num(w_all, nan=0.0, posinf=0.0, neginf=0.0)
    w_all = w_all * (w_all > 1e-5)

    # normalize jointly over all patch/corner contributions per pixel
    # (pers2equi_v3.py:189-192)
    N = erp_h * erp_w
    w_px = w_all.transpose(1, 2, 0, 3).reshape(N, P, 4)
    denom = np.maximum(w_px.sum(axis=(1, 2), keepdims=True), 1e-12)
    w_px = w_px / denom

    # fold clamped corners AFTER normalization (the folded pairs point at
    # the same source pixel, so sums are equal)
    xc = (x1 == x0).transpose(1, 2, 0).reshape(N, P)
    yc = (y1 == y0).transpose(1, 2, 0).reshape(N, P)
    w_px = _fold_clamped_corners(w_px, xc, yc)

    base = (
        (np.arange(P, dtype=np.int64) * (ph * pw))[:, None, None] + y0 * pw + x0
    )  # (P, H, W)
    base_px = base.transpose(1, 2, 0).reshape(N, P)

    # compact to the top-K contributing patches per pixel
    totals = w_px.sum(axis=-1)  # (N, P)
    K = max(int((totals > 0).sum(axis=1).max()), 1)
    order = np.argsort(-totals, axis=1, kind="stable")[:, :K]
    rows = np.arange(N)[:, None]
    w_k = w_px[rows, order]  # (N, K, 4)
    idx_k = np.where(totals[rows, order] > 0, base_px[rows, order], 0)

    idx_k = np.asarray(idx_k, dtype=np.int32)
    w_k = np.asarray(w_k, dtype=np.float32)
    return Pers2EquiGrids(
        idx=idx_k,
        w4=w_k,
        capped=build_capped_tables(idx_k, w_k),
        vjp=build_vjp_tables(idx_k, w_k, P * ph * pw),
        spec=spec,
    )


def build_capped_tables(idx_k: np.ndarray, w_k: np.ndarray) -> CappedTables | None:
    """Re-pack a slot-sorted (N, K) quad table as dense cap + sorted COO tail.

    Picks the cap that minimizes ``N*cap + _SCATTER_COST*tail(cap)``;
    returns None when the dense table wins. Slots must be live-first
    per pixel (build_pers2equi_grids sorts by descending weight).
    """
    n, k = idx_k.shape
    live = w_k.sum(-1) > 0  # (N, K), front-packed per row
    counts = live.sum(1)
    tail_sizes = [int(np.maximum(counts - cap, 0).sum()) for cap in range(1, k + 1)]
    costs = [n * cap + _SCATTER_COST * t for cap, t in zip(range(1, k + 1), tail_sizes)]
    cap = int(np.argmin(costs)) + 1
    if cap == k:
        return None
    tail_pix, tail_slot = np.nonzero(live[:, cap:])  # row-major: sorted by pixel
    tail_slot = tail_slot + cap
    tail_ptr = np.concatenate([[0], np.cumsum(np.bincount(tail_pix, minlength=n))])
    return CappedTables(
        idx=np.ascontiguousarray(idx_k[:, :cap]),
        w4=np.ascontiguousarray(w_k[:, :cap]),
        tail_pix=tail_pix.astype(np.int32),
        tail_idx=idx_k[tail_pix, tail_slot].astype(np.int32),
        tail_w=np.ascontiguousarray(w_k[tail_pix, tail_slot]),
        tail_ptr=tail_ptr.astype(np.int32),
    )
