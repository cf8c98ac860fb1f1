"""The benchmark's frozen arithmetic: the card's peaks, each hand kernel's
bytes and operations, and the model's FLOPs.

Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity), at 700 W.

Kernel work (a copy of the port's ``utils/profiling.py`` formulas,
counted from the cell's shapes and from the reference's own tables, so
the count stays the same whatever implements a kernel):

- a quad blend (``quad_blend``, the projections): every source pixel that
  a live corner reads, read once per source row; the output written once;
  each live quad's index and four weights (20 bytes) read once; 8
  operations per live quad and row;
- its transpose (``quad_spread``, their backward): the cotangent read and
  the result written once, the same quads' tables read once; 8
  operations per live quad and row;
- ``up2x``: its input read and its four times larger output written
  once, 9 operations per output; ``up2x_adjoint``: the four times larger
  cotangent read and the result written once, 15 operations per result.

A call's bound is the larger of its bytes over the memory rate and its
operations over the f32 rate (``bound_s``).

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the reference at
the cell's shapes on the meta device (convolutions, matrix products and
attention; elementwise work counts 0), forward or forward and backward.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference import model as ref
from benchmark.reference import tables

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 66.9e12, "tf32": 494.7e12, "bf16": 989.4e12}
# the peak of a trunk's precision: f32 convolutions run in TF32 on the
# card, PyTorch's default (torch.backends.cudnn.allow_tf32)
TRUNK_PEAK = {"bf16": PEAK_FLOPS["bf16"], "f32": PEAK_FLOPS["tf32"]}
SIZE = {"f32": 4, "bf16": 2, "f16": 2}
TABLE_BYTES_PER_QUAD = 4 + 4 * 4
KERNELS = {  # family -> substring of its kernels' names in a trace
    "quad_blend": "quad_blend_kernel",
    "quad_spread": "quad_spread",
    "up2x": "up2x_kernel",
    "up2x_adjoint": "up2x_adjoint_kernel",
}


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS["f32"])


@functools.lru_cache(maxsize=None)
def _table_counts(erp, patch, fov, nrows):
    """(source pixels read, live quads) of e2p, of the quarter-resolution
    e2p, and of p2e."""
    out = {}
    for key, p in (("e2p", patch), ("e2p_quarter", (patch[0] // 4, patch[1] // 4))):
        idx, w = tables.e2p(erp, p, fov, nrows)
        out[key] = (len(np.unique(idx[w > 0])), len(idx))
    idx, w = tables.p2e(erp, patch, fov, nrows)
    live = w.sum(-1) > 0
    out["p2e"] = (len(np.unique(idx[w > 0])), int(live.sum()))
    return out


def table_counts(cfg):
    return _table_counts(tuple(cfg["erp_size"]), tuple(cfg["patch_size"]), tuple(cfg["fov"]),
                         cfg["nrows"])


def blend_work(rows, n_src_pixels, n_quads, src_size, n_out, out_size):
    return (rows * n_src_pixels * src_size + rows * n_out * out_size
            + n_quads * TABLE_BYTES_PER_QUAD, 8.0 * n_quads * rows)


def spread_work(rows, n_cot, n_in, n_quads):
    return rows * (n_cot + n_in) * 4 + n_quads * TABLE_BYTES_PER_QUAD, 8.0 * n_quads * rows


def up2x_work(numel, size):
    return 5 * numel * size, 9.0 * 4 * numel


def up2x_adjoint_work(numel, size):
    return 5 * numel * size, 15.0 * numel


def kernel_bounds(cfg, precision: dict, batch: int, train: bool) -> dict:
    """family -> seconds: the sum of the bounds of the hand-kernel calls of
    one forward (serving) or one train step."""
    H, W = cfg["erp_size"]
    h, w = cfg["patch_size"]
    P = cfg["n_patches"]
    trunk, merge = precision["trunk"], precision["merge"]
    counts = table_counts(cfg)
    kind = ref.kind(cfg)
    passes, mc = kind.passes(cfg), kind.merge_rows(cfg)
    out = {k: 0.0 for k in KERNELS}
    src, quads = counts["e2p"]
    out["quad_blend"] += bound_s(*blend_work(batch * 3, src, quads, SIZE[trunk], P * h * w,
                                             SIZE[trunk]))
    src, quads = counts["p2e"]
    out["quad_blend"] += passes * bound_s(*blend_work(batch * mc, src, quads, SIZE[merge], H * W, 4))
    if train:
        out["quad_spread"] += passes * bound_s(*spread_work(batch * mc, H * W, P * h * w, quads))
    if passes > 1:
        src, quads = counts["e2p_quarter"]
        out["quad_blend"] += (passes - 1) * bound_s(
            *blend_work(batch, src, quads, 4, P * (h // 4) * (w // 4), 4))
    emb, hh, _ = ref.token_size(cfg)
    c4 = cfg["encoder_stages"][-1][0]
    d = cfg["decoder_channels"]
    chans = [c4, d[1], d[3], d[5], d[7]]
    for i, c in enumerate(chans):
        side = (h >> (5 - i), w >> (5 - i))
        numel = batch * P * c * side[0] * side[1]
        # under a bf16 trunk the first upsample reads layer4 plus the
        # transformer's f32 tokens, which is f32 where they are added whole
        dt = "f32" if (trunk == "f32" or (i == 0 and emb == c4)) else trunk
        out["up2x"] += passes * bound_s(*up2x_work(numel, SIZE[dt]))
        if train:
            out["up2x_adjoint"] += passes * bound_s(*up2x_adjoint_work(numel, SIZE[dt]))
    return out


def flops_per_panorama(cfg, batch: int, train: bool) -> float:
    """Model FLOPs per panorama of a forward (or forward and backward) of
    the reference at ``batch``, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    kind = ref.kind(cfg)
    p = {}
    for name, shape, k in kind.param_specs(cfg):
        dt = torch.long if k == "bn_n" else torch.float32
        p[name] = torch.empty(shape, device=meta, dtype=dt).requires_grad_(train and dt != torch.long)
    geom = ref.Geometry(cfg, meta)
    H, W = cfg["erp_size"]
    rgb = torch.empty(batch, H, W, 3, device=meta)
    counter = FlopCounterMode(display=False)
    with counter:
        preds = kind.forward(p, cfg, geom, rgb, train=train)
        if train:
            sum(d.sum() for d in preds).backward()
    return counter.get_total_flops() / batch
