"""The reference side of the model kind ``seg``: OmniFusion's semantic
segmentation (upstream ``train_erp_sem.py``, 13 Stanford2D3D classes) in
plain PyTorch, on the shared trunk of ``model.py``.

The one-shot trunk once, with the one-shot model's point features of the
patch centres (5 channels a quarter-resolution pixel) added to layer1;
a logit head of ``num_classes`` outputs (no ReLU) and the confidence
(sigmoid); a confidence-weighted merge to ERP of ``num_classes + 1`` f32
rows a panorama (logits times confidence, and the confidence), then the
guarded divide. Trained with cross-entropy over the pixels whose label is
not -1 (``train_erp_sem.py:203``).

Departures from upstream, whose semantic trainer does not run as it
stands (its ``dataset_sem`` is missing, :18, and its forward call at :202
matches the legacy network, not ``model/spherical_model.py``): the layer
equations are the JAX package's reading, which the port follows, and not
a published network; no upstream line is known to define a class head or
a merge of class logits:

- the merge of confidence-weighted logits, the one-shot depth merge
  applied to each class's logits (the main one);
- the logit head as the depth head's 3x3 conv with ``num_classes``
  outputs and no ReLU, beside the one-shot model's confidence head;
- seeded labels, not Stanford2D3D's.

Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref
from benchmark.reference.oneshot import calibrate, geometry, geometry_input  # noqa: F401

RECIPE = ref.Precision(convs="bf16", merge="f32")  # the serving recipe's precision
SERVE_CHECK = "logit_gap"
IGNORE = -1  # the label of a pixel left out of the loss
IGNORED_SHARE = 0.1  # of the seeded labels, set to IGNORE


def param_specs(cfg) -> list[tuple[str, tuple, str]]:
    return (ref.trunk_specs(cfg, "down", cfg["num_classes"])
            + ref.points_specs(cfg, "mlp_points", 5))


def passes(cfg) -> int:
    return 1


def merge_rows(cfg) -> int:
    """Rows a panorama of the merge's source."""
    return cfg["num_classes"] + 1


def merge(geom, cfg, logits, conf, b, prec):
    """(B*P, C, h, w) logits and (B*P, 1, h, w) confidence -> (B, H, W, C)
    logits."""
    H, W = cfg["erp_size"]
    nc = logits.shape[1]
    idx, w = geom.p2e
    lg = logits.reshape(b, cfg["n_patches"], nc, -1).transpose(1, 2).reshape(b, nc, -1)
    conf = conf.reshape(b, 1, -1)
    src = ref.rounded(torch.cat([lg * conf, conf], 1), prec.merge)
    merged = ref.merge_blend(src, idx, w)
    num, den = merged[:, :nc], merged[:, nc:]
    den = den + 1e-8 * (den <= 1e-8).to(den.dtype)
    return (num / den).reshape(b, nc, H, W).permute(0, 2, 3, 1)


def forward(p, cfg, geom, rgb, prec=ref.Precision(), train=False):
    """rgb (B, H, W, 3) -> [logits (B, H, W, num_classes)]."""
    b = rgb.shape[0]
    x = ref.patches(geom, cfg, rgb)
    pf = ref.points(p, "mlp_points", geom.geo, train, prec.convs)
    pf = pf.expand(b, *pf.shape).reshape(b * cfg["n_patches"], *pf.shape[1:])
    y = ref.trunk(p, cfg, x, pf, b, train, prec, "down")
    return [merge(geom, cfg, *ref.heads(p, y, prec, relu=False), b, prec)]


def loss(preds, batch):
    """Cross-entropy of the logits, the mean over the pixels whose label is
    not ``IGNORE``; 0 where every label is."""
    labels = batch["labels"].long()
    nll = F.cross_entropy(preds[0].permute(0, 3, 1, 2), labels, ignore_index=IGNORE,
                          reduction="sum")
    return nll / (labels != IGNORE).sum().clamp(min=1)


def targets(cfg, traffic, gen, n, device) -> dict:
    """n label maps (n, H, W) of classes 0..num_classes-1, ``IGNORED_SHARE``
    of the pixels set to ``IGNORE``, drawn from ``gen`` after the
    panoramas."""
    h, w = cfg["erp_size"]
    labels = torch.randint(0, cfg["num_classes"], (n, h, w), generator=gen, device=device)
    ignored = torch.rand(n, h, w, generator=gen, device=device) < IGNORED_SHARE
    return {"labels": labels.masked_fill(ignored, IGNORE)}
