"""BatchNorm over the global batch: the data axis's BatchNorm.

Under the JAX mesh a BatchNorm's ``jnp.mean`` over the sharded batch is the
mean over the global batch, and the running variance is unbiased with the
global count (omnifusion_tpu/models/layers.py:53-66). ``GlobalBatchNorm2d``
computes the same over ranks with ``all_reduce`` alone, which gloo runs for
CPU and CUDA tensors and nccl for CUDA ones, so the code that the CPU tests
hold against the JAX mesh is the code that runs on the cards:

- forward: ``[sum x, n]``, then ``sum (x - mean)^2`` (two rounds: the
  one-pass ``E[x^2] - E[x]^2`` cancels); normalized in f32 (f64 for an f64
  input) and returned in the input's dtype, as the port's BatchNorms do
  under a bf16 trunk; the running statistics take the global mean and the
  global unbiased variance;
- backward: ``[sum dy, sum dy * xhat]`` for the input's gradient. The scale's
  and the bias's gradients are this rank's sums: DistributedDataParallel
  averages them over the ranks with every other gradient. It keeps ``x``,
  the mean and ``1 / std``, not the normalized input.

Rank shards may differ in size. In eval mode it is ``nn.BatchNorm2d`` on the
running statistics, with no collective. ``nn.SyncBatchNorm`` is not used:
it refuses CPU tensors, turns into a plain BatchNorm at world size 1, and
needs ``all_gather``. With no process group up the sums are this process's.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from omnifusion_torch.parallel.mesh import all_reduce_


def _stat(t: torch.Tensor) -> torch.Tensor:
    """(C,) -> (1, C, 1, 1), to broadcast over an NCHW tensor."""
    return t.reshape(1, -1, 1, 1)


class _GlobalBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum: float, eps: float):
        cdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cdt)
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float64, device=x.device)
        sums = all_reduce_(torch.cat([xf.sum(dims).double(), count]))
        n = sums[-1]
        mean = (sums[:-1] / n).to(cdt)
        centered = xf - _stat(mean)
        var = all_reduce_(centered.square().sum(dims).double()) / n
        invstd = torch.rsqrt(var + eps).to(cdt)
        unbiased = var * n / (n - 1).clamp_min(1)
        running_mean.mul_(1 - momentum).add_(momentum * mean.to(running_mean.dtype))
        running_var.mul_(1 - momentum).add_(momentum * unbiased.to(running_var.dtype))
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return (centered * _stat(invstd * weight.to(cdt)) + _stat(bias.to(cdt))).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        cdt = mean.dtype
        dims = (0, 2, 3)
        xhat = (x.to(cdt) - _stat(mean)) * _stat(invstd)
        dyf = dy.to(cdt)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        sum_dy, sum_dy_xhat = (all_reduce_(local.clone()) / n.to(cdt)).chunk(2)
        dx = (dyf - _stat(sum_dy) - xhat * _stat(sum_dy_xhat)) * _stat(invstd * weight.to(cdt))
        c = x.shape[1]
        return (dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None, None, None, None)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode statistics are the global
    batch's, over the ranks of the process group; the same state-dict
    keys. For the port's BatchNorms (``models.layers.TorchBatchNorm``):
    affine, with running statistics and a momentum."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                      self.running_var, self.momentum, self.eps)


def convert_global_batchnorm(module: nn.Module, keep: Iterable[str] = ()) -> nn.Module:
    """Replace every ``nn.BatchNorm2d`` under ``module`` by a
    ``GlobalBatchNorm2d`` holding the same parameter and buffer tensors (an
    optimizer built before keeps working), except those under the module
    names in ``keep``: BatchNorms whose input is the same on every rank (the
    geometric embeddings of the one-shot and segmentation models), whose
    statistics are already the global ones and whose count must stay the
    local one. Returns ``module``, converted in place."""
    keep = tuple(keep)
    for name, child in list(module.named_modules()):
        for attr, bn in list(child.named_children()):
            full = f"{name}.{attr}" if name else attr
            if type(bn) is not nn.BatchNorm2d or any(
                    full == k or full.startswith(k + ".") for k in keep):
                continue
            new = GlobalBatchNorm2d(bn.num_features, bn.eps, bn.momentum, bn.affine,
                                    bn.track_running_stats, device="meta")
            new.weight, new.bias = bn.weight, bn.bias
            for buf in ("running_mean", "running_var", "num_batches_tracked"):
                setattr(new, buf, getattr(bn, buf))
            setattr(child, attr, new.train(bn.training))
    return module
