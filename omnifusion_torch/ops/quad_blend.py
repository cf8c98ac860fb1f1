"""Static sparse quad gather-blend: the runtime op of both projections.

Replaces the Pallas kernel ``omnifusion_tpu/ops/pallas_blend.py:
_dm_blend_kernel`` (with its wrappers ``quad_gather_blend_pallas``, the
channel-first capped merge, and ``quad_gather_blend_pallas_cl``, the
channel-last equi2pers) and the XLA path it stands in for
(``omnifusion_tpu/ops/sparse_blend.py``:
``quad_gather_blend``/``capped_quad_gather_blend``).

For each output pixel n and source row d (one batch/channel pair)::

    out[d, n] = sum_k sum_q w4[n, k, q] * src[d, (idx[n, k] + off_q) mod N_in]
              + sum over the pixel's COO tail entries m of
                sum_q tail_w[m, q] * src[d, (tail_idx[m] + off_q) mod N_in]

with ``off = (0, 1, W, W + 1)`` for a source row stride W. The result is the
f32 accumulator whatever the source dtype (f32, f16 or bf16), the Pallas
convention (pallas_blend.py:238-246): for a 16-bit source it is more precise
than the source dtype, and the merge divides in f32 anyway.

Three things live here:

- ``quad_blend``: the wrapper. On a CUDA tensor it launches the CUDA kernel
  (``omnifusion_torch/csrc/quad_blend.cu``) and adds one to
  ``quad_blend.launches``; on a CPU tensor it runs ``quad_blend_plain``;
  on any other device it raises.
- ``quad_blend_plain``: the same function in plain PyTorch.
- ``BlendTables``: the tables as tensors on one device.

Bound on the card: bytes (source + output + tables over 3.35 TB/s); the
kernel reads each table row once per 8 source rows and the four corners
straight from the source, with no packed or padded copy. See the CUDA
source for the design.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from omnifusion_torch.ops import _build

_MAX_ROWS = 8 * 65535  # grid.y = ceil(rows / 8) must fit the launch limit


@dataclasses.dataclass(frozen=True, eq=False)
class BlendTables:
    """Quad tables of one static sparse map, as tensors on one device.

    idx (N_out, K) int32 top-left corners and w4 (N_out, K, 4) f32 weights
    in [00, 01, 10, 11] order; an optional sorted COO tail with its CSR row
    pointers ``tail_ptr`` (N_out + 1); the source's pixel count ``n_in`` and
    row stride."""

    idx: torch.Tensor
    w4: torch.Tensor
    row_stride: int
    n_in: int
    tail_ptr: Optional[torch.Tensor] = None
    tail_pix: Optional[torch.Tensor] = None
    tail_idx: Optional[torch.Tensor] = None
    tail_w: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls, idx, w4, row_stride: int, n_in: int, device,
        tail_ptr=None, tail_pix=None, tail_idx=None, tail_w=None,
    ) -> "BlendTables":
        def t(a, dtype):
            if a is None:
                return None
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        idx = np.asarray(idx)
        assert idx.ndim == 2 and np.asarray(w4).shape == idx.shape + (4,), (
            idx.shape, np.asarray(w4).shape,
        )
        has_tail = tail_ptr is not None and len(tail_idx) > 0
        return cls(
            idx=t(idx, np.int32),
            w4=t(w4, np.float32),
            row_stride=int(row_stride),
            n_in=int(n_in),
            tail_ptr=t(tail_ptr, np.int32) if has_tail else None,
            tail_pix=t(tail_pix, np.int32) if has_tail else None,
            tail_idx=t(tail_idx, np.int32) if has_tail else None,
            tail_w=t(tail_w, np.float32) if has_tail else None,
        )

    @property
    def n_out(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    @property
    def n_tail(self) -> int:
        return 0 if self.tail_idx is None else self.tail_idx.shape[0]


def _rows(src: torch.Tensor, tables: BlendTables, channel_last: bool):
    """(B, C) and the (B*C, N_in) view of the source as f32 rows."""
    if channel_last:
        b, n_in, c = src.shape
        rows = src.permute(0, 2, 1).reshape(b * c, n_in)
    else:
        b, c, n_in = src.shape
        rows = src.reshape(b * c, n_in)
    if n_in != tables.n_in:
        raise ValueError(f"source has {n_in} pixels, the tables {tables.n_in}")
    return b, c, rows.float()


def quad_blend_plain(
    src: torch.Tensor, tables: BlendTables, channel_last: bool = False
) -> torch.Tensor:
    """The gather-blend in plain PyTorch: the kernel's reference.

    src (B, C, N_in), or (B, N_in, C) when ``channel_last``; returns f32
    (B, C, N_out), or (B, N_out, C)."""
    b, c, s = _rows(src, tables, channel_last)
    n_in, w = tables.n_in, tables.row_stride
    idx = tables.idx.long()
    out = torch.zeros(b * c, tables.n_out, dtype=torch.float32, device=src.device)
    for q, off in enumerate((0, 1, w, w + 1)):
        corner = s[:, (idx + off) % n_in]  # (D, N_out, K)
        out += (corner * tables.w4[:, :, q]).sum(-1)
    if tables.n_tail:
        tail_idx = tables.tail_idx.long()
        vals = sum(
            s[:, (tail_idx + off) % n_in] * tables.tail_w[:, q]
            for q, off in enumerate((0, 1, w, w + 1))
        )  # (D, M)
        out.index_add_(1, tables.tail_pix.long(), vals)
    out = out.reshape(b, c, tables.n_out)
    return out.permute(0, 2, 1).contiguous() if channel_last else out


def quad_blend(
    src: torch.Tensor, tables: BlendTables, channel_last: bool = False
) -> torch.Tensor:
    """Gather-blend ``src`` through ``tables``; see the module docstring.

    src (B, C, N_in) contiguous, or (B, N_in, C) when ``channel_last``, in
    f32, f16 or bf16; returns f32 (B, C, N_out), or (B, N_out, C)."""
    if src.device.type == "cpu":
        return quad_blend_plain(src, tables, channel_last)
    if src.device.type != "cuda":
        raise ValueError(f"quad_blend runs on cuda or cpu tensors, got {src.device}")
    if src.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"quad_blend: unsupported source dtype {src.dtype}")
    if src.dim() != 3 or not src.is_contiguous():
        raise ValueError(f"quad_blend: need a contiguous 3-D source, got {tuple(src.shape)}")
    if tables.idx.device != src.device:
        raise ValueError(f"tables on {tables.idx.device}, source on {src.device}")
    if channel_last:
        b, n_in, c = src.shape
        s_b, s_p, s_c = src.stride()
        out = torch.empty(b, tables.n_out, c, dtype=torch.float32, device=src.device)
        o_b, o_p, o_c = out.stride()
    else:
        b, c, n_in = src.shape
        s_b, s_c, s_p = src.stride()
        out = torch.empty(b, c, tables.n_out, dtype=torch.float32, device=src.device)
        o_b, o_c, o_p = out.stride()
    if n_in != tables.n_in:
        raise ValueError(f"source has {n_in} pixels, the tables {tables.n_in}")
    if b * c > _MAX_ROWS:
        raise ValueError(f"quad_blend: {b * c} source rows exceed {_MAX_ROWS}")
    tail = tables.n_tail > 0
    err = _build.library().omnifusion_quad_blend(
        src.data_ptr(),
        _build.DTYPE_CODES[src.dtype],
        out.data_ptr(),
        tables.idx.data_ptr(),
        tables.w4.data_ptr(),
        tables.k,
        tables.tail_ptr.data_ptr() if tail else None,
        tables.tail_idx.data_ptr() if tail else None,
        tables.tail_w.data_ptr() if tail else None,
        b * c,
        c,
        n_in,
        tables.n_out,
        tables.row_stride,
        s_b,
        s_c,
        s_p,
        o_b,
        o_c,
        o_p,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(err, "quad_blend")
    quad_blend.launches += 1
    return out


quad_blend.launches = 0
