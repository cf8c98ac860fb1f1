"""Static sparse quad gather-blend, the runtime op of both projections, and
its transpose, the op of their backward.

Replaces the Pallas kernels ``omnifusion_tpu/ops/pallas_blend.py:
_dm_blend_kernel`` (with its wrappers ``quad_gather_blend_pallas``, the
channel-first capped merge, and ``quad_gather_blend_pallas_cl``, the
channel-last equi2pers) and ``_dm_spread_kernel`` (wrapper
``transposed_quad_gather_blend_pallas``), and the XLA paths they stand in for
(``omnifusion_tpu/ops/sparse_blend.py``: ``quad_gather_blend``,
``capped_quad_gather_blend``, ``transposed_quad_gather_blend``), with the
custom VJP of ``_with_table_vjp`` (sparse_blend.py:379-418).

For each output pixel n and source row d (one batch/channel pair)::

    out[d, n] = sum_k sum_q w4[n, k, q] * src[d, (idx[n, k] + off_q) mod N_in]
              + sum over the pixel's COO tail entries m of
                sum_q tail_w[m, q] * src[d, (tail_idx[m] + off_q) mod N_in]

with ``off = (0, 1, W, W + 1)`` for a source row stride W. The result is the
f32 accumulator whatever the source dtype (f32, f16 or bf16), the Pallas
convention (pallas_blend.py:238-246): for a 16-bit source it is more precise
than the source dtype, and the merge divides in f32 anyway.

The backward is ``g_src = W^T g_out``, applied from the transposed tables
(projection/spec.py: build_vjp_tables) and returned in the source's dtype,
as ``_with_table_vjp`` re-casts it (sparse_blend.py:413-415).

What lives here:

- ``quad_blend``: the differentiable wrapper, an ``autograd.Function`` whose
  backward is ``quad_spread``. Its forward launches the CUDA kernel
  (``omnifusion_torch/csrc/quad_blend.cu``) on a CUDA tensor and adds one to
  ``quad_blend.launches`` and to the counter ``quad_blend.staged`` or
  ``quad_blend.global`` (``utils/profiling.count``), by the plan
  ``blend_plan`` chose; on a CPU tensor it runs ``quad_blend_plain``; on
  any other device it raises.
- ``quad_spread``: the transposed blend. On a CUDA tensor it launches the
  CUDA kernel (``omnifusion_torch/csrc/quad_spread.cu``) and adds one to
  ``quad_spread.launches``; on a CPU tensor it runs ``quad_spread_plain``.
- ``quad_blend_plain`` and ``quad_spread_plain``: the same functions in
  plain PyTorch. Autograd never differentiates them: both run inside the
  Function, with autograd off.
- ``gather_blend``: the K-way weighted gather of ``sparse_blend.py:165``,
  plain PyTorch (XLA in the JAX package, not a Pallas kernel).
- ``BlendTables`` and ``SpreadTables``: the tables as tensors on one device;
  ``BlendTables`` also carries ``tiles`` (``TileTables``, built by
  ``tile_tables``): the output tiles of the kernel's blocks, each tile's
  source footprint and every corner's place in it; ``SpreadTables`` carries
  the ``heavy`` list of the pixels whose overflow load is above
  ``HEAVY_THRESHOLD`` (``heavy_pixels``), which the kernel's second launch
  walks.

Bound on the card, both directions: bytes (source + output + tables over
3.35 TB/s). See the CUDA sources for the designs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from omnifusion_torch.ops import _build
from omnifusion_torch.utils.profiling import count

_MAX_ROWS = 8 * 65535  # quad_spread: grid.y = ceil(rows / 8) must fit the launch limit
# quad_blend (csrc/quad_blend.cu): a block blends a TILE of (rows, columns)
# output pixels over every source row, staging CHUNK_ROWS source rows at a
# time (a chunk of C-row units for a (B, N, C) source) of the tile's
# footprint, the GROUP-pixel groups its corners touch, in shared memory
# (double-buffered); fewer rows where the largest footprint would take more
# than BLOCK_SMEM bytes (four blocks of 256 threads on an SM), and none
# where one unit does not fit SMEM_BYTES, a block's most, twice; a pixel keeps
# at most MAX_ENTRIES quads (slots + tail) in registers, and the kernel reads
# those past them from global memory for every row. The staging pays
# where the footprint holds at most STAGE_MAX_FOOTPRINT staged pixels per
# output pixel (the merge: 1.4, at every batch); else (equi2pers, 4.6: it
# samples the ERP at about one pixel in three) the kernel gathers from
# global memory, a block taking GLOBAL_UNIT_ROWS rows and grid.y the rest,
# so that the rows in flight stay in L2 (the H100 sweep in PERF.md)
GROUP = 8
TILE = (8, 32)
CHUNK_ROWS = 16
BLOCK_SMEM = 56 * 1024
SMEM_BYTES = 227 * 1024
MAX_ENTRIES = 8
STAGE_MAX_FOOTPRINT = 2.0
GLOBAL_UNIT_ROWS = 24
# quad_spread: a source pixel whose overflow load L(i) (the summed length of
# the four CSR segments its thread would walk) is above HEAVY_THRESHOLD goes
# to the kernel's heavy launch: a warp per pixel and row group, or a block of
# 256 threads where the load is above WIDE_LOAD; the rest walk their
# segments alone (csrc/quad_spread.cu)
HEAVY_THRESHOLD = 32
WIDE_LOAD = 256


def _tensor(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def overflow_load(over_ptr: np.ndarray, row_stride: int) -> np.ndarray:
    """L(i) = sum_q seg((i - off_q) mod N_in) for every source pixel i, from
    the CSR row pointers of a transposed table's overflow: the entries one
    quad_spread thread would walk for pixel i."""
    seg = np.diff(np.asarray(over_ptr, np.int64))
    return sum(np.roll(seg, off) for off in (0, 1, row_stride, row_stride + 1))


def heavy_pixels(
    over_ptr: np.ndarray, row_stride: int, threshold: int = HEAVY_THRESHOLD,
    wide_load: int = WIDE_LOAD,
) -> tuple[np.ndarray, int]:
    """The pixels of quad_spread's heavy launch: (heavy, n_wide), the int32
    source pixels whose load is above ``threshold``, sorted heaviest first
    (ties by pixel), and how many of them, at the front, have a load above
    ``wide_load`` and take a whole block."""
    load = overflow_load(over_ptr, row_stride)
    heavy = np.flatnonzero(load > threshold)
    heavy = heavy[np.argsort(-load[heavy], kind="stable")]
    return heavy.astype(np.int32), int((load[heavy] > wide_load).sum())


@dataclasses.dataclass(frozen=True, eq=False)
class SpreadTables:
    """Transposed quad tables of one static sparse map, as tensors on one
    device (projection/spec.py: TransposedTables).

    idx_t (N_in, K_T) int32 output pixels and w_t (N_in, K_T, 4) f32 corner
    weights, keyed by the forward's source pixel; the overflow sorted by
    destination with its CSR row pointers ``over_ptr`` (N_in + 1); the
    forward's output pixel count ``n_out`` and the source row stride;
    ``heavy`` and ``n_wide``, the int32 pixels whose overflow load is above
    ``threshold``, heaviest first, and how many of them take a whole block
    (``heavy_pixels``; empty without an overflow, and needed by the kernel
    whenever there is one)."""

    idx_t: torch.Tensor
    w_t: torch.Tensor
    row_stride: int
    n_out: int
    over_ptr: Optional[torch.Tensor] = None
    over_dst: Optional[torch.Tensor] = None
    over_src: Optional[torch.Tensor] = None
    over_w: Optional[torch.Tensor] = None
    heavy: Optional[torch.Tensor] = None
    n_wide: int = 0
    threshold: int = HEAVY_THRESHOLD

    @classmethod
    def create(cls, t, row_stride: int, n_out: int, device) -> "SpreadTables":
        """From a projection/spec.py TransposedTables."""
        has_over = len(t.over_src) > 0
        heavy, n_wide = heavy_pixels(t.over_ptr, row_stride) if has_over else (np.zeros(0), 0)
        return cls(
            idx_t=_tensor(t.idx_t, np.int32, device),
            w_t=_tensor(t.w_t, np.float32, device),
            row_stride=int(row_stride),
            n_out=int(n_out),
            over_ptr=_tensor(t.over_ptr, np.int32, device) if has_over else None,
            over_dst=_tensor(t.over_dst, np.int32, device) if has_over else None,
            over_src=_tensor(t.over_src, np.int32, device) if has_over else None,
            over_w=_tensor(t.over_w, np.float32, device) if has_over else None,
            heavy=_tensor(heavy, np.int32, device),
            n_wide=n_wide,
        )

    @property
    def n_in(self) -> int:
        return self.idx_t.shape[0]

    @property
    def k_t(self) -> int:
        return self.idx_t.shape[1]

    @property
    def n_over(self) -> int:
        return 0 if self.over_src is None else self.over_src.shape[0]


def tile_tables(
    idx, row_stride: int, n_in: int, out_w: Optional[int] = None, shape=TILE,
    tail_ptr=None, tail_pix=None, tail_idx=None,
) -> dict:
    """The kernel's tile tables of a quad table, in numpy.

    The N_out output pixels are rows of ``out_w`` (default: the tile's
    width, so a tile is a run of consecutive pixels), cut into tiles of
    ``shape`` = (rows, columns), row-major; ragged edges belong to partial
    tiles. A tile's footprint is the ascending list of GROUP-pixel groups
    (pixels GROUP*g .. GROUP*g + GROUP - 1 of the source) that its quads'
    corners (idx + off_q) mod N_in touch, for off = (0, 1, W, W + 1), slots
    and tail. Returns ``grp_ptr`` (n_tiles + 1) and ``grp``, the footprints
    as CSR; ``off`` (N_out, K, 4) and ``tail_off`` (M, 4) int16, each
    corner's pixel in its tile's staged footprint (GROUP * its group's place
    + its place in the group); ``pitch``, the pixels of the largest
    footprint; ``footprint``, the staged pixels per output pixel, over all
    tiles; ``entries``, the most quads (slots + tail) of one pixel; and
    ``shape``, ``out_w``, ``tiles_x``, ``n_tiles``."""
    idx = np.asarray(idx, np.int64)
    n_out, k = idx.shape
    th, tw = shape
    out_w = tw if out_w is None else int(out_w)
    tiles_x = -(-out_w // tw)
    n_tiles = tiles_x * -(-(-(-n_out // out_w)) // th)
    n_groups = -(-n_in // GROUP)
    # int32 where the keys fit: the sort below is most of the build's time
    itype = np.int32 if n_tiles * n_groups < 2**31 and n_in + row_stride < 2**30 else np.int64

    def tile_of(n):
        n = np.asarray(n, itype)
        return (n // out_w // th) * tiles_x + (n % out_w) // tw

    def wrapped(j):  # (j + off_q) mod N_in, for 0 <= j < N_in
        c = np.asarray(j, itype)[..., None] + np.array([0, 1, row_stride, row_stride + 1], itype)
        return np.where(c >= n_in, c - n_in, c)

    corners = [wrapped(idx)]  # (N_out, K, 4)
    tiles = [np.broadcast_to(tile_of(np.arange(n_out))[:, None, None], corners[0].shape)]
    has_tail = tail_idx is not None and len(tail_idx) > 0
    if has_tail:
        corners.append(wrapped(tail_idx))  # (M, 4)
        tiles.append(np.broadcast_to(tile_of(tail_pix)[:, None], corners[1].shape))
    corner = np.concatenate([c.ravel() for c in corners])
    keys = np.concatenate([t.ravel() for t in tiles]) * itype(n_groups) + corner // GROUP
    uniq, inv = np.unique(keys, return_inverse=True)
    tile_u = uniq // n_groups
    grp_ptr = np.searchsorted(tile_u, np.arange(n_tiles + 1))
    pos = (np.arange(len(uniq), dtype=itype) - grp_ptr[tile_u].astype(itype))[inv.ravel()]
    pos = pos * GROUP + corner % GROUP
    pitch = GROUP * int(np.diff(grp_ptr).max(initial=1))
    if pitch > 2**15:
        raise ValueError(f"quad_blend: a tile's footprint of {pitch} pixels passes int16 offsets")
    n_slot = n_out * k * 4
    tail_len = np.diff(np.asarray(tail_ptr, np.int64)) if has_tail else np.zeros(1, np.int64)
    return {
        "grp_ptr": grp_ptr.astype(np.int32),
        "grp": (uniq % n_groups).astype(np.int32),
        "off": pos[:n_slot].reshape(n_out, k, 4).astype(np.int16),
        "tail_off": pos[n_slot:].reshape(-1, 4).astype(np.int16) if has_tail else None,
        "pitch": pitch,
        "footprint": GROUP * len(uniq) / n_out,
        "entries": k + int(tail_len.max()),
        "shape": (th, tw), "out_w": out_w, "tiles_x": tiles_x, "n_tiles": n_tiles,
    }


@dataclasses.dataclass(frozen=True, eq=False)
class TileTables:
    """``tile_tables`` as tensors on one device: what csrc/quad_blend.cu
    reads besides the quad weights."""

    grp_ptr: torch.Tensor
    grp: torch.Tensor
    off: torch.Tensor
    tail_off: Optional[torch.Tensor]
    pitch: int
    footprint: float
    entries: int
    shape: tuple
    out_w: int
    tiles_x: int
    n_tiles: int

    @classmethod
    def create(cls, device, **kw) -> "TileTables":
        """From ``tile_tables(**kw)``."""
        t = tile_tables(**kw)
        for name, dtype in (("grp_ptr", np.int32), ("grp", np.int32), ("off", np.int16),
                            ("tail_off", np.int16)):
            if t[name] is not None:
                t[name] = _tensor(t[name], dtype, device)
        return cls(**t)


@dataclasses.dataclass(frozen=True, eq=False)
class BlendTables:
    """Quad tables of one static sparse map, as tensors on one device.

    idx (N_out, K) int32 top-left corners and w4 (N_out, K, 4) f32 weights
    in [00, 01, 10, 11] order; an optional sorted COO tail with its CSR row
    pointers ``tail_ptr`` (N_out + 1); the source's pixel count ``n_in`` and
    row stride; ``vjp``, the transposed tables of the same map, which the
    backward needs (None: the map cannot be differentiated); ``tiles``, the
    kernel's tile tables (``TileTables``), which the kernel needs."""

    idx: torch.Tensor
    w4: torch.Tensor
    row_stride: int
    n_in: int
    tail_ptr: Optional[torch.Tensor] = None
    tail_pix: Optional[torch.Tensor] = None
    tail_idx: Optional[torch.Tensor] = None
    tail_w: Optional[torch.Tensor] = None
    vjp: Optional[SpreadTables] = None
    tiles: Optional[TileTables] = None

    @classmethod
    def create(
        cls, idx, w4, row_stride: int, n_in: int, device,
        tail_ptr=None, tail_pix=None, tail_idx=None, tail_w=None, vjp=None, out_w=None,
        tile=TILE,
    ) -> "BlendTables":
        """``vjp``: the map's projection/spec.py TransposedTables, or None;
        ``out_w``: the width of the output image, along which the kernel's
        tiles of ``tile`` (rows, columns) lie (None: tiles of consecutive
        pixels)."""
        idx = np.asarray(idx)
        assert idx.ndim == 2 and np.asarray(w4).shape == idx.shape + (4,), (
            idx.shape, np.asarray(w4).shape,
        )
        has_tail = tail_ptr is not None and len(tail_idx) > 0
        tail = {"tail_ptr": tail_ptr, "tail_pix": tail_pix, "tail_idx": tail_idx} if has_tail else {}
        return cls(
            idx=_tensor(idx, np.int32, device),
            w4=_tensor(w4, np.float32, device),
            row_stride=int(row_stride),
            n_in=int(n_in),
            tail_ptr=_tensor(tail_ptr, np.int32, device) if has_tail else None,
            tail_pix=_tensor(tail_pix, np.int32, device) if has_tail else None,
            tail_idx=_tensor(tail_idx, np.int32, device) if has_tail else None,
            tail_w=_tensor(tail_w, np.float32, device) if has_tail else None,
            vjp=None if vjp is None else SpreadTables.create(vjp, row_stride, idx.shape[0], device),
            tiles=TileTables.create(device, idx=idx, row_stride=row_stride, n_in=n_in,
                                    out_w=out_w, shape=tile, **tail),
        )

    def with_tiles(self, shape) -> "BlendTables":
        """These tables with tiles of another ``shape`` (rows, columns)."""
        cpu = lambda t: None if t is None else t.cpu().numpy()  # noqa: E731
        tiles = TileTables.create(
            self.idx.device, idx=cpu(self.idx), row_stride=self.row_stride, n_in=self.n_in,
            out_w=self.tiles.out_w, shape=shape, tail_ptr=cpu(self.tail_ptr),
            tail_pix=cpu(self.tail_pix), tail_idx=cpu(self.tail_idx),
        )
        return dataclasses.replace(self, tiles=tiles)

    @property
    def n_out(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    @property
    def n_tail(self) -> int:
        return 0 if self.tail_idx is None else self.tail_idx.shape[0]


def _rows(x: torch.Tensor, n: int, channel_last: bool):
    """(B, C) and the (B*C, N) view of ``x`` as f32 rows (f64 rows for an
    f64 ``x``: a float64 run of the plain versions is a float64 witness)."""
    if channel_last:
        b, n_x, c = x.shape
        rows = x.permute(0, 2, 1).reshape(b * c, n_x)
    else:
        b, c, n_x = x.shape
        rows = x.reshape(b * c, n_x)
    if n_x != n:
        raise ValueError(f"input has {n_x} pixels, the tables {n}")
    return b, c, rows.to(torch.promote_types(rows.dtype, torch.float32))


def _unrows(rows: torch.Tensor, b: int, c: int, channel_last: bool) -> torch.Tensor:
    out = rows.reshape(b, c, rows.shape[1])
    return out.permute(0, 2, 1).contiguous() if channel_last else out


def _corners(row_stride: int):
    return enumerate((0, 1, row_stride, row_stride + 1))


def quad_blend_plain(
    src: torch.Tensor, tables: BlendTables, channel_last: bool = False, out_dtype=None
) -> torch.Tensor:
    """The gather-blend in plain PyTorch: the kernel's reference.

    src (B, C, N_in), or (B, N_in, C) when ``channel_last``; returns f32
    (f64 for an f64 source), or ``out_dtype``, (B, C, N_out), or (B, N_out,
    C)."""
    b, c, s = _rows(src, tables.n_in, channel_last)
    n_in = tables.n_in
    idx = tables.idx.long()
    out = torch.zeros(b * c, tables.n_out, dtype=s.dtype, device=src.device)
    for q, off in _corners(tables.row_stride):
        corner = s[:, (idx + off) % n_in]  # (D, N_out, K)
        out += (corner * tables.w4[:, :, q]).sum(-1)
    if tables.n_tail:
        tail_idx = tables.tail_idx.long()
        vals = sum(
            s[:, (tail_idx + off) % n_in] * tables.tail_w[:, q]
            for q, off in _corners(tables.row_stride)
        )  # (D, M)
        out.index_add_(1, tables.tail_pix.long(), vals)
    out = _unrows(out, b, c, channel_last)
    return out if out_dtype is None else out.to(out_dtype)


def quad_spread_plain(
    cot: torch.Tensor, tables: SpreadTables, channel_last: bool = False
) -> torch.Tensor:
    """The transposed blend in plain PyTorch, as the JAX package computes
    it (sparse_blend.py:188-268): four corner planes from the transposed
    table and the overflow, shifted by the corner offsets and summed.

    cot (B, C, N_out), or (B, N_out, C) when ``channel_last``; returns f32
    (f64 for an f64 cotangent) (B, C, N_in), or (B, N_in, C)."""
    b, c, g = _rows(cot, tables.n_out, channel_last)
    vals = g[:, tables.idx_t.long()]  # (D, N_in, K_T)
    out = torch.zeros(b * c, tables.n_in, dtype=g.dtype, device=cot.device)
    for q, off in _corners(tables.row_stride):
        plane = (vals * tables.w_t[:, :, q]).sum(-1)  # (D, N_in)
        if tables.n_over:
            plane.index_add_(
                1, tables.over_dst.long(), g[:, tables.over_src.long()] * tables.over_w[:, q]
            )
        out += torch.roll(plane, off, dims=1)  # out[i] += plane[(i - off) mod N_in]
    return _unrows(out, b, c, channel_last)


def gather_blend(src_flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted gather along the pixel axis (sparse_blend.py:165-187).

    src_flat (B, N_in, C); idx (N_out, K) indices into N_in (entries with
    zero weight may point anywhere valid); w (N_out, K) weights, cast to the
    source's dtype, as the JAX package does. Returns (B, N_out, C) =
    sum_k w[n, k] * src_flat[:, idx[n, k], :]."""
    g = src_flat[:, idx.long()]  # (B, N_out, K, C)
    return (g * w.to(src_flat.dtype)[..., None]).sum(2)


def _strides(x: torch.Tensor, channel_last: bool):
    """(B, C, pixels) and their strides of a 3-D tensor."""
    if channel_last:
        (b, p, c), (s_b, s_p, s_c) = x.shape, x.stride()
    else:
        (b, c, p), (s_b, s_c, s_p) = x.shape, x.stride()
    return b, c, p, s_b, s_c, s_p


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: need a contiguous 3-D tensor, got {tuple(x.shape)}")


def blend_plan(
    tiles: TileTables, units: int, cpu: int, elem_size: int, staged: Optional[bool] = None,
    chunk_rows: int = CHUNK_ROWS, unit_block: Optional[int] = None,
) -> tuple[bool, int, int]:
    """How csrc/quad_blend.cu runs a call of ``units`` units of ``cpu``
    elements per pixel: (staged, units staged per step, units per block).
    Arguments left None follow the module's rule, which stages a dense
    footprint only where one unit of it fits shared memory twice (a
    channel-last source of many channels gathers from global memory);
    raises where staging is asked for and does not fit."""
    unit_bytes = tiles.pitch * cpu * elem_size  # one staged unit
    if staged is None:
        staged = tiles.footprint <= STAGE_MAX_FOOTPRINT and 2 * unit_bytes <= SMEM_BYTES
    if unit_block is None:
        unit_block = units if staged else max(1, GLOBAL_UNIT_ROWS // cpu)
    unit_block = max(unit_block, -(-units // 65535))  # grid.y's limit
    if staged and 2 * unit_bytes > SMEM_BYTES:
        raise ValueError(f"quad_blend: a tile's footprint of {tiles.pitch} pixels does not fit "
                         f"shared memory twice")
    chunk = max(1, min(chunk_rows // cpu, units, unit_block, BLOCK_SMEM // (2 * unit_bytes)))
    return staged, chunk, unit_block


def _blend_kernel(
    src: torch.Tensor, tables: BlendTables, channel_last: bool, out_dtype=None,
    staged: Optional[bool] = None, chunk_rows: int = CHUNK_ROWS,
    unit_block: Optional[int] = None,
) -> torch.Tensor:
    """Launch csrc/quad_blend.cu: one launch, a block per output tile and
    ``unit_block`` units. ``staged``: stage the footprint in shared memory,
    or gather from global memory; ``chunk_rows``: the source rows staged
    per step. None: the module's rule for the one and the other."""
    _check_cuda(src, "quad_blend")
    if tables.idx.device != src.device:
        raise ValueError(f"tables on {tables.idx.device}, source on {src.device}")
    tiles = tables.tiles
    if tiles is None:
        raise ValueError("quad_blend: tables without their tile tables (BlendTables.create)")
    if channel_last:
        b, n_in, c = src.shape
        units, cpu = b, c
    else:
        b, c, n_in = src.shape
        units, cpu = b * c, 1
    if n_in != tables.n_in:
        raise ValueError(f"source has {n_in} pixels, the tables {tables.n_in}")
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, src.dtype):
        raise TypeError(f"quad_blend: stores f32 or the source's dtype, not {out_dtype}")
    if n_in * cpu >= 2**31:
        raise ValueError(f"quad_blend: {n_in} pixels of {cpu} elements pass 32-bit offsets")
    staged, chunk, unit_block = blend_plan(tiles, units, cpu, src.element_size(), staged,
                                           chunk_rows, unit_block)
    shape = (b, tables.n_out, c) if channel_last else (b, c, tables.n_out)
    out = torch.empty(shape, dtype=out_dtype, device=src.device)
    tail = tables.n_tail > 0
    th, tw = tiles.shape
    err = _build.library().omnifusion_quad_blend(
        src.data_ptr(),
        _build.DTYPE_CODES[src.dtype],
        out.data_ptr(),
        _build.DTYPE_CODES[out_dtype],
        tables.w4.data_ptr(),
        tiles.off.data_ptr(),
        tables.idx.data_ptr(),
        tables.k,
        tables.tail_ptr.data_ptr() if tail else None,
        tables.tail_w.data_ptr() if tail else None,
        tiles.tail_off.data_ptr() if tail else None,
        tables.tail_idx.data_ptr() if tail else None,
        tiles.grp_ptr.data_ptr(),
        tiles.grp.data_ptr(),
        tiles.n_tiles,
        tiles.tiles_x,
        th,
        tw,
        tiles.pitch,
        units,
        unit_block,
        cpu,
        n_in,
        tables.n_out,
        tables.row_stride,
        tiles.out_w,
        tiles.entries,
        chunk,
        int(staged),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(err, "quad_blend")
    quad_blend.launches += 1
    count("quad_blend.staged" if staged else "quad_blend.global")
    return out


def _spread_kernel(cot: torch.Tensor, tables: SpreadTables, channel_last: bool) -> torch.Tensor:
    """Launch csrc/quad_spread.cu: the light kernel, then, when the tables
    have heavy pixels, the heavy kernel on the same stream (two CUDA
    launches, one count)."""
    _check_cuda(cot, "quad_spread")
    if tables.idx_t.device != cot.device:
        raise ValueError(f"tables on {tables.idx_t.device}, cotangent on {cot.device}")
    b, c, n_out, c_b, c_c, c_p = _strides(cot, channel_last)
    if n_out != tables.n_out:
        raise ValueError(f"cotangent has {n_out} pixels, the tables {tables.n_out}")
    if b * c > _MAX_ROWS:
        raise ValueError(f"quad_spread: {b * c} rows exceed {_MAX_ROWS}")
    shape = (b, tables.n_in, c) if channel_last else (b, c, tables.n_in)
    out = torch.empty(shape, dtype=torch.float32, device=cot.device)
    _, _, _, o_b, o_c, o_p = _strides(out, channel_last)
    over = tables.n_over > 0
    if over and tables.heavy is None:
        raise ValueError("quad_spread: tables with an overflow need their heavy list "
                         "(SpreadTables.create)")
    n_heavy = tables.heavy.shape[0] if over else 0
    err = _build.library().omnifusion_quad_spread(
        cot.data_ptr(),
        _build.DTYPE_CODES[cot.dtype],
        out.data_ptr(),
        tables.idx_t.data_ptr(),
        tables.w_t.data_ptr(),
        tables.k_t,
        tables.over_ptr.data_ptr() if over else None,
        tables.over_src.data_ptr() if over else None,
        tables.over_w.data_ptr() if over else None,
        tables.threshold,
        tables.heavy.data_ptr() if n_heavy else None,
        n_heavy,
        tables.n_wide,
        b * c,
        c,
        n_out,
        tables.n_in,
        tables.row_stride,
        c_b,
        c_c,
        c_p,
        o_b,
        o_c,
        o_p,
        torch.cuda.current_stream(cot.device).cuda_stream,
    )
    _build.check(err, "quad_spread")
    quad_spread.launches += 1
    return out


def quad_spread(
    cot: torch.Tensor, tables: SpreadTables, channel_last: bool = False
) -> torch.Tensor:
    """Apply the transposed map to ``cot``: the source gradient of the blend.

    cot (B, C, N_out) contiguous, or (B, N_out, C) when ``channel_last``, in
    f32, f16 or bf16; returns f32 (B, C, N_in), or (B, N_in, C). On a CUDA
    tensor one call is two kernel launches when the tables have heavy pixels
    (the light pass, then the heavy one) and adds one to ``launches``."""
    if _build.on_cuda(cot, "quad_spread"):
        return _spread_kernel(cot, tables, channel_last)
    return quad_spread_plain(cot, tables, channel_last)


class _QuadBlend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, tables, channel_last, out_dtype):
        ctx.tables, ctx.channel_last, ctx.src_dtype = tables, channel_last, src.dtype
        if _build.on_cuda(src, "quad_blend"):
            return _blend_kernel(src, tables, channel_last, out_dtype)
        return quad_blend_plain(src, tables, channel_last, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        if ctx.tables.vjp is None:
            raise RuntimeError("quad_blend: these tables carry no transposed tables")
        g = quad_spread(cot.contiguous(), ctx.tables.vjp, ctx.channel_last)
        return g.to(ctx.src_dtype), None, None, None


def quad_blend(
    src: torch.Tensor, tables: BlendTables, channel_last: bool = False, out_dtype=None
) -> torch.Tensor:
    """Gather-blend ``src`` through ``tables``; see the module docstring.

    src (B, C, N_in) contiguous, or (B, N_in, C) when ``channel_last``, in
    f32, f16 or bf16; returns f32 (B, C, N_out), or (B, N_out, C), or the
    f32 sums rounded once to ``out_dtype`` (the kernel stores f32 or the
    source's dtype). Differentiable in ``src`` when the tables carry
    ``vjp``."""
    return _QuadBlend.apply(src, tables, channel_last, out_dtype)


quad_blend.launches = 0
quad_spread.launches = 0
