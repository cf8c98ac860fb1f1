"""Runtime projection ops: equi2pers / pers2equi / pers2equi_cf.

The port's counterpart of ``omnifusion_tpu/projection/ops.py``, with the
JAX package's layouts at the public functions:

  ERP image:                 (B, H, W, C)
  patch stack:               (B, P, h, w, C)
  channel-first patch stack: (B, C, P*h*w)

Each op is one static sparse gather-blend (ops/quad_blend.py): on a CUDA
tensor it launches its kernel, on a CPU tensor it runs its plain version.
Each is differentiable in its input: the backward applies the transposed
tables (the transposed kernel on the card). The tables, forward and
transposed, move to a device once per (spec, device) and stay cached.
``equi2pers_full``, ``project`` and ``unproject`` add the static geometric
features and the grids' lookup, as the JAX functions do.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from omnifusion_torch.ops.quad_blend import BlendTables, quad_blend
from omnifusion_torch.projection.spec import (
    Equi2PersGrids,
    Pers2EquiGrids,
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)


class PatchProjection(NamedTuple):
    """equi2pers result bundle (mirrors the reference's 4-tuple return)."""

    pers: torch.Tensor  # (B, P, h, w, C)
    xyz: torch.Tensor  # (P, h, w, 3)
    uv: torch.Tensor  # (P, h, w, 2)
    centers: torch.Tensor  # (P, 2)


# the blend kernel's output tile for equi2pers, which gathers from global
# memory: 4 x 32 patch pixels (the merge keeps quad_blend.TILE; PERF.md)
E2P_TILE = (4, 32)


@functools.lru_cache(maxsize=None)
def equi2pers_tables(spec: ProjectionSpec, device: torch.device) -> BlendTables:
    g = build_equi2pers_grids(spec)
    return BlendTables.create(
        g.idx, g.w4, spec.erp_w, spec.erp_h * spec.erp_w, device, vjp=g.vjp,
        out_w=spec.patch_w, tile=E2P_TILE,
    )


@functools.lru_cache(maxsize=None)
def pers2equi_tables(spec: ProjectionSpec, device: torch.device) -> BlendTables:
    g = build_pers2equi_grids(spec)
    n_in = spec.n_patches * spec.patch_h * spec.patch_w
    if g.capped is None:
        return BlendTables.create(
            g.idx, g.w4, spec.patch_w, n_in, device, vjp=g.vjp, out_w=spec.erp_w
        )
    # the capped map is the dense one re-packed: one transposed table serves both
    c = g.capped
    return BlendTables.create(
        c.idx, c.w4, spec.patch_w, n_in, device,
        tail_ptr=c.tail_ptr, tail_pix=c.tail_pix, tail_idx=c.tail_idx, tail_w=c.tail_w,
        vjp=g.vjp, out_w=spec.erp_w,
    )


def equi2pers(erp: torch.Tensor, grids: Equi2PersGrids) -> torch.Tensor:
    """Project an ERP image onto all tangent patches.

    erp: (B, H, W, C) -> (B, P, h, w, C) in erp's dtype: the blend's f32
    sums rounded once (on the card, by the kernel's store)."""
    spec = grids.spec
    b, h, w, c = erp.shape
    if (h, w) != (spec.erp_h, spec.erp_w):
        raise ValueError(f"ERP {tuple(erp.shape)} does not match {spec}")
    src = erp.contiguous().reshape(b, h * w, c)
    out = quad_blend(src, equi2pers_tables(spec, erp.device), channel_last=True,
                     out_dtype=erp.dtype)
    return out.reshape(b, spec.n_patches, spec.patch_h, spec.patch_w, c)


def pers2equi_cf(pers_cf: torch.Tensor, grids: Pers2EquiGrids) -> torch.Tensor:
    """Channel-first merge of tangent patches back to ERP.

    pers_cf: (B, C, P*h*w) -> (B, C, H, W). The result is the blend's f32
    accumulator whatever the source dtype (ops/quad_blend.py)."""
    spec = grids.spec
    b, c, n_in = pers_cf.shape
    if n_in != spec.n_patches * spec.patch_h * spec.patch_w:
        raise ValueError(f"patch stack {tuple(pers_cf.shape)} does not match {spec}")
    out = quad_blend(pers_cf.contiguous(), pers2equi_tables(spec, pers_cf.device))
    return out.reshape(b, c, spec.erp_h, spec.erp_w)


def equi2pers_full(erp: torch.Tensor, grids: Equi2PersGrids) -> PatchProjection:
    """equi2pers plus the static geometric features (xyz, uv, centers), f32
    tensors on erp's device."""
    feats = (torch.from_numpy(a).to(erp.device) for a in (grids.xyz, grids.uv, grids.centers))
    return PatchProjection(equi2pers(erp, grids), *feats)


def pers2equi(pers: torch.Tensor, grids: Pers2EquiGrids) -> torch.Tensor:
    """Merge tangent patches back to an ERP image, channel-last.

    pers: (B, P, h, w, C) -> (B, H, W, C) in pers's dtype (the blend's f32
    sums rounded once, as the JAX function's XLA path keeps the source
    dtype). Overlapping patches are blended with the precomputed
    L1-normalized bilinear weights: the same map and tables as
    pers2equi_cf."""
    spec = grids.spec
    b, p, h, w, c = pers.shape
    if (p, h, w) != (spec.n_patches, spec.patch_h, spec.patch_w):
        raise ValueError(f"patch stack {tuple(pers.shape)} does not match {spec}")
    src = pers.contiguous().reshape(b, p * h * w, c)
    out = quad_blend(src, pers2equi_tables(spec, pers.device), channel_last=True,
                     out_dtype=pers.dtype)
    return out.reshape(b, spec.erp_h, spec.erp_w, c)


def project(erp: torch.Tensor, spec: ProjectionSpec) -> PatchProjection:
    """Build (or load) the grids of ``spec`` and run equi2pers_full."""
    return equi2pers_full(erp, build_equi2pers_grids(spec))


def unproject(pers: torch.Tensor, spec: ProjectionSpec) -> torch.Tensor:
    """Build (or load) the grids of ``spec`` and run pers2equi."""
    return pers2equi(pers, build_pers2equi_grids(spec))
