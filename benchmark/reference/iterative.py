"""The reference side of the model kind ``iterative``: OmniFusion's
iterative refinement (upstream ``model/spherical_model_iterative.py``)
in plain PyTorch, on the shared trunk of ``model.py``.

The trunk runs ``num_iters`` times. The first pass adds point features of
the unit sphere at quarter resolution to layer1; each later pass adds
point features of the previous pass's depth, sampled back to
quarter-resolution patches, times the unit sphere. Depth head (ReLU);
unweighted merges (one row a panorama), as the port serves them. Trained
with BerHu on every pass's depth.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from benchmark.reference import model as ref
from benchmark.reference import tables

RECIPE = ref.Precision(convs="bf16", merge="f16")  # the serving recipe's precision
SERVE_CHECK = "depth_gap"
loss = ref.depth_loss
targets = ref.depth_targets


def param_specs(cfg) -> list[tuple[str, tuple, str]]:
    return (ref.trunk_specs(cfg, "down1", 1) + ref.points_specs(cfg, "mlp_points1", 3)
            + ref.points_specs(cfg, "mlp_points2", 3))


def passes(cfg) -> int:
    return cfg["num_iters"]


def merge_rows(cfg) -> int:
    """Rows a panorama of the merge's source."""
    return 1


def geometry_input(cfg) -> np.ndarray:
    """The first points embedding's input, (P, 3, h/4, w/4): the unit
    sphere at quarter resolution."""
    h, w = cfg["patch_size"]
    return tables.unit_sphere((h // 4, w // 4), cfg["fov"], cfg["nrows"])


def geometry(geom, cfg):
    erp, (h, w), fov, nrows = cfg["erp_size"], cfg["patch_size"], cfg["fov"], cfg["nrows"]
    quarter = (h // 4, w // 4)
    n = cfg["n_patches"] * quarter[0] * quarter[1]
    geom.e2p_quarter = geom.blend(tables.e2p, (erp, quarter, fov, nrows), (n, 4))
    geom.xyz = geom.tensor(lambda: geometry_input(cfg), (cfg["n_patches"], 3, *quarter))


def calibrate(p, cfg, x, geo, stats):
    """Run what holds BatchNorms on the calibration patches x (P, 3, h, w)
    in ``stats``' train mode: both points embeddings, the second on the
    first pass's depth pooled to quarter resolution."""
    pf = ref.points(p, "mlp_points1", geo, stats, "f32")
    y = ref.trunk(p, cfg, x, pf, 1, stats, ref.Precision(), "down1")
    pred, _ = ref.heads(p, y, ref.Precision(), relu=True)
    depth = F.avg_pool2d(pred, 4)  # (P, 1, h/4, w/4)
    ref.points(p, "mlp_points2", geo * depth, stats, "f32")


def merge(geom, cfg, pred, b, prec):
    """(B*P, 1, h, w) depth head -> (B, H, W, 1) depth, unweighted."""
    H, W = cfg["erp_size"]
    idx, w = geom.p2e
    src = ref.rounded(pred.reshape(b, -1)[:, None], prec.merge)
    return ref.merge_blend(src, idx, w).reshape(b, H, W, 1)


def forward(p, cfg, geom, rgb, prec=ref.Precision(), train=False):
    """rgb (B, H, W, 3) -> the list of each pass's depth (B, H, W, 1)."""
    b = rgb.shape[0]
    P = cfg["n_patches"]
    h, w = cfg["patch_size"]
    hq, wq = h // 4, w // 4
    x = ref.patches(geom, cfg, rgb)

    def one_pass(pf):
        pred, _ = ref.heads(p, ref.trunk(p, cfg, x, pf, b, train, prec, "down1"), prec, relu=True)
        return merge(geom, cfg, pred, b, prec)

    pf = ref.points(p, "mlp_points1", geom.xyz, train, prec.convs)
    preds = [one_pass(pf.expand(b, *pf.shape).reshape(b * P, *pf.shape[1:]))]
    for _ in range(cfg["num_iters"] - 1):
        d = ref.sample(preds[-1].reshape(b, -1, 1), *geom.e2p_quarter)  # (B, P*hq*wq, 1)
        pts = geom.xyz[None] * d.reshape(b, P, 1, hq, wq)
        preds.append(one_pass(ref.points(p, "mlp_points2", pts.reshape(b * P, 3, hq, wq), train,
                                         prec.convs)))
    return preds
