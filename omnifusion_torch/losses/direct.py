"""Direct depth supervision losses.

The port's counterpart of ``omnifusion_tpu/losses/direct.py`` (upstream
supervision/direct.py). The BerHu cutoff is data-dependent (c = max|diff| / 5
over ALL pixels, masked or not) and detached, as the JAX package stops its
gradient. Under data parallelism the max is the global batch's (an
all-reduce of each rank's), as a max over the JAX mesh's sharded batch is;
over the world it is also the data axis's max, since the model ranks of a
data group hold the same merged depth. The per-sample mean over a data
group's equal shard, averaged over the data axis by the DDP wrap, is the
global batch's mean.
"""

from __future__ import annotations

import torch

from omnifusion_torch.parallel.mesh import all_reduce_


def _per_sample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(x, like.shape).reshape(like.shape[0], -1).to(torch.float32)


def berhu_loss(pred, gt, mask) -> torch.Tensor:
    """Adaptive reverse-Huber loss, per-sample masked mean.

    pred/gt/mask: (B, ...) broadcastable; mask selects valid pixels."""
    bs = pred.shape[0]
    diff = gt - pred
    abs_diff = diff.abs()
    c = all_reduce_(abs_diff.max().detach().reshape(1), "max")[0] / 5.0
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
