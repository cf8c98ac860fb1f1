"""Depth evaluation metrics.

The port's counterpart of ``omnifusion_tpu/evaluation/metrics.py`` (upstream
metrics.py:7-26 and the eval protocol of test.py:149-177: median scaling of
the prediction, pixel-count weighting). Every reduction is a masked mean on
the device, so a batch syncs with the host only when its numbers are read.
"""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


def abs_rel_error(pred, gt, mask):
    return _masked_mean((pred - gt).abs() / torch.clamp(gt, min=1e-12), mask > 0)


def sq_rel_error(pred, gt, mask):
    return _masked_mean((pred - gt).square() / torch.clamp(gt, min=1e-12), mask > 0)


def lin_rms_sq_error(pred, gt, mask):
    return _masked_mean((pred - gt).square(), mask > 0)


def log_rms_sq_error(pred, gt, mask):
    valid = (mask > 0) & (pred > 1e-7) & (gt > 1e-7)
    log_diff = torch.clamp(pred, min=1e-7).log() - torch.clamp(gt, min=1e-7).log()
    return _masked_mean(log_diff.square(), valid)


def delta_inlier_ratio(pred, gt, mask, degree: int = 1):
    safe_pred = torch.clamp(pred, min=1e-12)
    safe_gt = torch.clamp(gt, min=1e-12)
    ratio = torch.maximum(safe_pred / safe_gt, safe_gt / safe_pred)
    return _masked_mean((ratio < 1.25**degree).float(), mask > 0)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over masked elements, torch semantics: the LOWER of the two
    middle elements for an even count (torch.median, used at test.py:160)."""
    v = torch.where(mask > 0, values, torch.full_like(values, float("inf"))).reshape(-1)
    v = torch.sort(v).values
    count = (mask > 0).sum()
    return v[torch.clamp(count - 1, min=0) // 2]


def compute_depth_metrics(pred, gt, mask, median_scale: bool = True):
    """The test.py metric suite on one batch: (metrics dict of 0-d tensors,
    N), N the valid-pixel count that weights the batch in a meter."""
    n = (mask > 0).float().sum()
    if median_scale:
        pred = pred * (masked_median(gt, mask) / torch.clamp(masked_median(pred, mask), min=1e-12))
    metrics = {
        "abs_rel": abs_rel_error(pred, gt, mask),
        "sq_rel": sq_rel_error(pred, gt, mask),
        "lin_rms_sq": lin_rms_sq_error(pred, gt, mask),
        "log_rms_sq": log_rms_sq_error(pred, gt, mask),
        "d1": delta_inlier_ratio(pred, gt, mask, 1),
        "d2": delta_inlier_ratio(pred, gt, mask, 2),
        "d3": delta_inlier_ratio(pred, gt, mask, 3),
    }
    return metrics, n
