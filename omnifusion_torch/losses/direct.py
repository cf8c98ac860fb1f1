"""Direct depth supervision losses.

The port's counterpart of ``omnifusion_tpu/losses/direct.py`` (upstream
supervision/direct.py). The BerHu cutoff is data-dependent (c = max|diff| / 5
over ALL pixels, masked or not) and detached, as the JAX package stops its
gradient.
"""

from __future__ import annotations

import torch


def _per_sample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(x, like.shape).reshape(like.shape[0], -1).to(torch.float32)


def berhu_loss(pred, gt, mask) -> torch.Tensor:
    """Adaptive reverse-Huber loss, per-sample masked mean.

    pred/gt/mask: (B, ...) broadcastable; mask selects valid pixels."""
    bs = pred.shape[0]
    diff = gt - pred
    abs_diff = diff.abs()
    c = abs_diff.max().detach() / 5.0
    l2 = (diff.square() + c.square()) / torch.clamp(2.0 * c, min=1e-12)
    loss = torch.where(abs_diff <= c, abs_diff, l2).reshape(bs, -1)
    mask = _per_sample(mask, pred)
    count = torch.clamp(mask.sum(1), min=1.0)
    return ((loss * mask).sum(1) / count).mean()


def l1_loss(pred, gt, mask) -> torch.Tensor:
    """Masked mean absolute error, per-sample normalized."""
    bs = pred.shape[0]
    loss = (gt - pred).abs().reshape(bs, -1)
    mask = _per_sample(mask, pred)
    count = torch.clamp(mask.sum(1), min=1.0)
    return ((loss * mask).sum(1) / count).mean()
