"""Edge-guided smoothness loss.

The port's counterpart of ``omnifusion_tpu/losses/smoothness.py`` (parity:
supervision/smoothness.py:3-7).
"""

from __future__ import annotations

import torch


def guided_smoothness_loss(input_duv, guide_duv, mask, weights=None):
    """Penalize prediction gradients where the guide image is smooth.

    input_duv/guide_duv: image-gradient magnitudes (e.g. from
    omnifusion_torch.ops.gradients.imgrad_yx); mask: boolean validity.
    """
    smooth = input_duv * torch.exp(-guide_duv)
    smooth = torch.where(mask, smooth, torch.zeros_like(smooth))
    if weights is not None:
        smooth = smooth * weights
    denom = mask.to(smooth.dtype).sum().clamp_min(1.0)
    return smooth.sum() / denom
