"""Runtime projection ops: equi2pers / pers2equi_cf.

The port's counterpart of ``omnifusion_tpu/projection/ops.py``, with the
JAX package's layouts at the public functions:

  ERP image:                 (B, H, W, C)
  patch stack:               (B, P, h, w, C)
  channel-first patch stack: (B, C, P*h*w)

Both ops are one static sparse gather-blend (ops/quad_blend.py): on a CUDA
tensor they launch its kernel, on a CPU tensor they run its plain version.
Both are differentiable in their input: the backward applies the transposed
tables (the transposed kernel on the card). The tables, forward and
transposed, move to a device once per (spec, device) and stay cached.
"""

from __future__ import annotations

import functools

import torch

from omnifusion_torch.ops.quad_blend import BlendTables, quad_blend
from omnifusion_torch.projection.spec import (
    Equi2PersGrids,
    Pers2EquiGrids,
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)


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
