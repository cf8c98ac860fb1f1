"""Semantic-segmentation mIoU (parity: iou.py in the reference).

The port's copy of ``omnifusion_tpu/utils/iou.py``, in numpy:
confusion-matrix-based per-class IoU with an ignore label < 0; the reference
hard-codes the 13 Stanford2D3D classes (iou.py:21-56).
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 13


def confusion_matrix(pred, gt, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """Bincount confusion matrix over the valid (0 <= gt < num_classes)
    pixels; rows are ground truth, columns predictions."""
    pred = np.asarray(pred).reshape(-1)
    gt = np.asarray(gt).reshape(-1)
    valid = (gt >= 0) & (gt < num_classes)
    idx = num_classes * gt[valid].astype(np.int64) + pred[valid].astype(np.int64)
    return np.bincount(idx, minlength=num_classes**2).reshape(num_classes, num_classes)


def per_class_iou(cm: np.ndarray) -> np.ndarray:
    """IoU per class = diag / (row + col - diag); NaN for a class absent
    from both the ground truth and the predictions."""
    diag = np.diag(cm).astype(np.float64)
    denom = cm.sum(1) + cm.sum(0) - diag
    with np.errstate(divide="ignore", invalid="ignore"):
        return diag / denom


def evaluate_iou(preds, gts, num_classes: int = NUM_CLASSES):
    """Accumulate over an iterable of (pred, gt) maps -> (mIoU, per-class);
    the mean skips the NaN classes."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    for pred, gt in zip(preds, gts):
        cm += confusion_matrix(pred, gt, num_classes)
    ious = per_class_iou(cm)
    return float(np.nanmean(ious)), ious
