"""The reference side of the model kind ``oneshot``: OmniFusion's one-shot
model (upstream ``model/spherical_model.py``) in plain PyTorch, on the
shared trunk of ``model.py``.

The trunk once; point features of the patch centres (5 channels a
quarter-resolution pixel) added to layer1; depth (ReLU) and confidence
(sigmoid) heads; a confidence-weighted merge to ERP (two rows a panorama,
depth times confidence and confidence). Trained with BerHu on depth and
mask.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as ref
from benchmark.reference import tables

RECIPE = ref.Precision(convs="bf16", merge="f16")  # the serving recipe's precision
SERVE_CHECK = "depth_gap"
loss = ref.depth_loss
targets = ref.depth_targets


def param_specs(cfg) -> list[tuple[str, tuple, str]]:
    return ref.trunk_specs(cfg, "down", 1) + ref.points_specs(cfg, "mlp_points", 5)


def passes(cfg) -> int:
    return 1


def merge_rows(cfg) -> int:
    """Rows a panorama of the merge's source."""
    return 2


def geometry_input(cfg) -> np.ndarray:
    """The points embedding's input, (P, 5, h/4, w/4): each patch's
    normalised centre, a one and the centre again."""
    h, w = cfg["patch_size"]
    c = tables.centers_normalized(cfg["nrows"])
    a = np.concatenate([c, np.ones_like(c[:, :1]), c], -1)[:, :, None, None]
    return np.broadcast_to(a, (*a.shape[:2], h // 4, w // 4))


def geometry(geom, cfg):
    h, w = cfg["patch_size"]
    geom.geo = geom.tensor(lambda: geometry_input(cfg), (cfg["n_patches"], 5, h // 4, w // 4))


def calibrate(p, cfg, x, geo, stats):
    """Run what holds BatchNorms on the calibration patches x (P, 3, h, w)
    in ``stats``' train mode."""
    pf = ref.points(p, "mlp_points", geo, stats, "f32")
    ref.trunk(p, cfg, x, pf, 1, stats, ref.Precision(), "down")


def merge(geom, cfg, pred, conf, b, prec):
    """(B*P, 1, h, w) heads -> (B, H, W, 1) depth."""
    H, W = cfg["erp_size"]
    idx, w = geom.p2e
    pred, conf = pred.reshape(b, -1), conf.reshape(b, -1)
    src = ref.rounded(torch.stack([pred * conf, conf], 1), prec.merge)
    num, den = ref.merge_blend(src, idx, w).unbind(1)
    den = den + 1e-8 * (den <= 1e-8).to(den.dtype)
    return (num / den).reshape(b, H, W, 1)


def forward(p, cfg, geom, rgb, prec=ref.Precision(), train=False):
    """rgb (B, H, W, 3) -> [depth (B, H, W, 1)]."""
    b = rgb.shape[0]
    x = ref.patches(geom, cfg, rgb)
    pf = ref.points(p, "mlp_points", geom.geo, train, prec.convs)
    pf = pf.expand(b, *pf.shape).reshape(b * cfg["n_patches"], *pf.shape[1:])
    y = ref.trunk(p, cfg, x, pf, b, train, prec, "down")
    return [merge(geom, cfg, *ref.heads(p, y, prec, relu=True), b, prec)]
