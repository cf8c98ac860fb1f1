"""Photometric (SSIM + L1) loss.

The port's counterpart of ``omnifusion_tpu/losses/photometric.py`` (parity:
supervision/photometric.py).
"""

from __future__ import annotations

import dataclasses

import torch

from omnifusion_torch.losses.ssim import ssim_loss


@dataclasses.dataclass(frozen=True)
class PhotometricLossParameters:
    alpha: float = 0.85
    window: int = 7
    std: float = 1.5
    ssim_mode: str = "gaussian"


def photometric_loss(pred, gt, params: PhotometricLossParameters, mask, weights=None):
    """alpha * (1 - SSIM)/2 + (1 - alpha) * L1, masked per-sample mean
    (supervision/photometric.py:34-51)."""
    valid = torch.broadcast_to(mask, pred.shape).to(pred.dtype)
    masked_gt = gt * valid
    masked_pred = pred * valid
    l1 = torch.abs(masked_gt - masked_pred)
    d_ssim = torch.clamp(
        (
            1.0
            - ssim_loss(
                masked_pred,
                masked_gt,
                kernel_size=params.window,
                std=params.std,
                mode=params.ssim_mode,
            )
        )
        / 2.0,
        0.0,
        1.0,
    )
    loss = d_ssim * params.alpha + l1 * (1.0 - params.alpha)
    loss = loss * valid
    if weights is not None:
        loss = loss * weights
    bs = pred.shape[0]
    count = valid.reshape(bs, -1).sum(1).clamp_min(1.0)
    return (loss.reshape(bs, -1).sum(1) / count).mean()
