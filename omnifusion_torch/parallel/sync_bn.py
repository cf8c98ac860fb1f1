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

Rank shards may differ in size. A batch that every rank holds whole (one
the ranks cannot split) keeps this process's statistics and count
(``replicated_batch``). Under ``--remat`` (``remat_contexts``) the
recompute of a forward reuses the statistics that the forward recorded.
In eval mode it is ``nn.BatchNorm2d`` on the running statistics, with no
collective. ``nn.SyncBatchNorm`` is not used:
it refuses CPU tensors, turns into a plain BatchNorm at world size 1, and
needs ``all_gather``. With no process group up the sums are this process's.
"""

from __future__ import annotations

import contextlib
from typing import Iterable

import torch
from torch import nn

from omnifusion_torch.parallel.mesh import all_reduce_


def _stat(t: torch.Tensor) -> torch.Tensor:
    """(C,) -> (1, C, 1, 1), to broadcast over an NCHW tensor."""
    return t.reshape(1, -1, 1, 1)


class _GlobalBatchNorm(torch.autograd.Function):
    """Normalization by given statistics (``GlobalBatchNorm2d.statistics``);
    the backward's sums are over the ranks unless ``local``."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, n, local: bool):
        cdt = mean.dtype
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.local = local
        centered = x.to(cdt) - _stat(mean)
        return (centered * _stat(invstd * weight.to(cdt)) + _stat(bias.to(cdt))).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        cdt = mean.dtype
        dims = (0, 2, 3)
        xhat = (x.to(cdt) - _stat(mean)) * _stat(invstd)
        dyf = dy.to(cdt)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        sums = local.clone() if ctx.local else all_reduce_(local.clone())
        sum_dy, sum_dy_xhat = (sums / n.to(cdt)).chunk(2)
        dx = (dyf - _stat(sum_dy) - xhat * _stat(sum_dy_xhat)) * _stat(invstd * weight.to(cdt))
        c = x.shape[1]
        return (dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None, None, None, None)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode statistics are the global
    batch's, over the ranks of the process group; the same state-dict
    keys. For the port's BatchNorms (``models.layers.TorchBatchNorm``):
    affine, with running statistics and a momentum.

    ``replicated``: every rank holds the same batch (``replicated_batch``),
    so the statistics are this process's, with no collective, and the
    running variance keeps the local count. ``_remat``: set by
    ``remat_contexts`` while a rematerialized forward records or replays
    the statistics."""

    replicated = False
    _remat = None

    def statistics(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, 1 / std, count) of ``x``'s global batch, and the running
        statistics and the batch count updated with them."""
        cdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cdt)
        dims = (0, 2, 3)
        reduce = (lambda t: t) if self.replicated else all_reduce_
        count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float64, device=x.device)
        sums = reduce(torch.cat([xf.sum(dims).double(), count]))
        n = sums[-1]
        mean = (sums[:-1] / n).to(cdt)
        var = reduce((xf - _stat(mean)).square().sum(dims).double()) / n
        unbiased = var * n / (n - 1).clamp_min(1)
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean.to(self.running_mean.dtype))
        self.running_var.mul_(1 - m).add_(m * unbiased.to(self.running_var.dtype))
        self.num_batches_tracked.add_(1)
        return mean, torch.rsqrt(var + self.eps).to(cdt), n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        with torch.no_grad():
            if self._remat is None:
                stats = self.statistics(x)
            elif self._remat[0] == "record":
                stats = self.statistics(x)
                self._remat[1].append(stats)
            else:  # replay: the recorded statistics, no collective, no update
                stats = self._remat[1].pop(0)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, *stats, self.replicated)


@contextlib.contextmanager
def replicated_batch(model: nn.Module):
    """While open, ``model``'s global BatchNorms take every rank's batch to
    be the same one (a batch that the ranks cannot split, given whole to
    each): their statistics and their backward's sums are this process's,
    and the running variance is unbiased with this process's count, as one
    process computes it. The other reductions need no such care: the
    segmentation loss's ``world * sum / count`` is then the local mean, and
    DistributedDataParallel averages equal gradients."""
    norms = [m for m in model.modules() if isinstance(m, GlobalBatchNorm2d)]
    for m in norms:
        m.replicated = True
    try:
        yield
    finally:
        for m in norms:
            del m.replicated


@contextlib.contextmanager
def _recording(norms, recorded: dict):
    for m in norms:
        m._remat = ("record", recorded.setdefault(m, []))
    try:
        yield
    finally:
        for m in norms:
            del m._remat


@contextlib.contextmanager
def _replaying(norms, plain, recorded: dict):
    for m in norms:
        m._remat = ("replay", recorded[m])
    # the plain BatchNorms run as in the forward (the same saved tensors),
    # then get back the statistics that the forward left
    buffers = [b for m in plain for b in (m.running_mean, m.running_var, m.num_batches_tracked)]
    with torch.no_grad():
        saved = [b.clone() for b in buffers]
    try:
        yield
    finally:
        for m in norms:
            del m._remat
        with torch.no_grad():
            for b, v in zip(buffers, saved):
                b.copy_(v)


def remat_contexts(modules: Iterable[nn.Module]):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` over a
    forward that runs ``modules``' BatchNorms in train mode: a pair of
    contexts, one around the forward and one around its recompute in the
    backward. The recompute normalizes as the forward did and leaves the
    running statistics and batch counts as the forward left them, as a flax
    remat discards its recompute's batch_stats: ``nn.BatchNorm2d`` computes
    its batch's statistics again and gets its buffers back after the
    recompute; ``GlobalBatchNorm2d`` reuses the statistics the forward
    recorded, with no collective and no update (its backward's all-reduce
    runs once, in the forward's graph)."""
    norms, plain = [], []
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, GlobalBatchNorm2d):
                norms.append(m)
            elif isinstance(m, nn.BatchNorm2d) and m.track_running_stats:
                plain.append(m)
    recorded: dict = {}
    return _recording(norms, recorded), _replaying(norms, plain, recorded)


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
