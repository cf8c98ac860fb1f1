"""NN building blocks, NCHW.

The port's counterpart of ``omnifusion_tpu/models/layers.py``:

- ``TorchBatchNorm`` is ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``, which the
  JAX module reproduces (biased variance to normalize, unbiased for the
  running stats); inference runs it in eval mode. Given a bf16 input it
  normalizes in f32 with its f32 scale and statistics and returns bf16, as
  the JAX module does (layers.py:51,72-73);
- ``torch_conv`` is ``nn.Conv2d`` with symmetric zero padding and a compute
  ``dtype``: given one, the input, weight and bias are cast to it at the
  call while the parameters stay f32, as flax's ``nn.Conv(dtype=...,
  param_dtype=f32)`` does; the state dict does not change;
- ``conv_bn_relu`` is conv -> BN (-> + residual) -> ReLU, the trunk's one
  pattern: where the BN is in eval mode, autograd records nothing and the
  input is on the card, the convolution on its cached bf16 weight, then the
  BN's scale and bias, the residual and the ReLU in one pass
  (``ops/epilogue.py``); elsewhere the modules one after the other (the JAX
  package leaves the fusion to XLA);
- ``resize_bilinear`` sends an exact 2x upsample to the up2x kernel
  (ops/upsample.py) and any other size to ``F.interpolate``, as the JAX
  function sends it to ``jax.image.resize``.

The tensors are NCHW in shape; in memory the encoder runs channels-last (the
e2p patches are a permuted view). On the card, where autograd records
nothing, the decoder keeps that layout through ``resize_bilinear`` to the
heads, so that cuDNN's bf16 convolutions, which are NHWC, need no transpose
and ``cat`` copies one layout. Elsewhere the decoder runs contiguous NCHW
from the first resize on: in training, the layout ``up2x``'s adjoint reads,
and on the CPU, whose plain versions the tests hold to the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from omnifusion_torch.ops import _build
from omnifusion_torch.ops.epilogue import conv_epilogue, memory_order
from omnifusion_torch.ops.upsample import up2x
from omnifusion_torch.utils.profiling import count


def TorchBatchNorm(features: int, device=None) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1, device=device)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` when one is set."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def torch_conv(
    in_features: int,
    features: int,
    kernel_size: int,
    stride: int = 1,
    padding: int = 0,
    use_bias: bool = False,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Conv:
    return Conv(
        in_features, features, kernel_size, stride=stride, padding=padding,
        bias=use_bias, device=device, compute_dtype=dtype,
    )


class ConvBnReLU(nn.Module):
    """conv (no bias) -> BN -> ReLU (the upstream ConvBnReLU_v2, with the
    patch axis in the batch)."""

    def __init__(
        self, in_features, features, kernel_size=3, stride=1, padding=1, dtype=None, device=None
    ):
        super().__init__()
        self.conv = torch_conv(
            in_features, features, kernel_size, stride, padding, dtype=dtype, device=device
        )
        self.bn = TorchBatchNorm(features, device=device)

    def forward(self, x):
        return conv_bn_relu(self.conv, self.bn, x)


def _fold_key(conv: Conv, bn: nn.BatchNorm2d, dtype: torch.dtype, fmt: torch.memory_format):
    """What a fold is computed from: each tensor's storage and version (a
    load or an optimizer step changes one; a train-mode forward updates the
    running statistics in place without a version, but counts the batch in
    ``num_batches_tracked``), eps, the dtype and the memory format; None
    where a tensor is an inference tensor, which keeps no version."""
    ts = [t for t in (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
                      bn.running_var, bn.num_batches_tracked) if t is not None]
    if any(t.is_inference() for t in ts):
        return None
    return tuple((t.data_ptr(), t._version) for t in ts) + (bn.eps, dtype, fmt)


def folded(conv: Conv, bn: nn.BatchNorm2d, dtype: torch.dtype, fmt: torch.memory_format):
    """(weight, scale, bias): ``conv``'s weight cast once to ``dtype`` in
    ``fmt`` (the rounding its call makes), and the eval-mode ``bn``'s affine
    map with ``conv``'s bias folded in, in f32 from the f32 parameters and
    running statistics (f64 from f64 ones): scale = γ / sqrt(var + eps),
    bias = β + (conv bias - mean) scale. The scale is applied to the
    convolution's output (``ops/epilogue.py``), not folded into the weight,
    which would round W scale to ``dtype`` anew (PERF.md §6). Cached on
    ``conv``, outside its state dict and parameters, until ``_fold_key``
    changes; the counter ``conv_fold.folds`` counts the folds computed."""
    key = _fold_key(conv, bn, dtype, fmt)
    cached = conv.__dict__.get("_folded")
    if key is not None and cached is not None and cached[0] == key:
        return cached[1:]
    count("conv_fold.folds")
    cdt = torch.promote_types(bn.weight.dtype, torch.float32)
    with torch.no_grad():
        w = conv.weight.to(dtype, memory_format=fmt)
        scale = bn.weight.to(cdt) / torch.sqrt(bn.running_var.to(cdt) + bn.eps)
        shift = -bn.running_mean.to(cdt)
        if conv.bias is not None:
            shift = shift + conv.bias.to(cdt)
        bias = bn.bias.to(cdt) + shift * scale
    entry = (w, scale, bias)
    if key is not None:
        conv.__dict__["_folded"] = (key, *entry)
    return entry


def _folds(bn: nn.BatchNorm2d, x: torch.Tensor) -> bool:
    """Where ``conv_bn_relu`` folds: ``bn`` in eval mode on running
    statistics, autograd recording nothing, ``x`` on the card."""
    return (not bn.training and bn.running_mean is not None
            and not torch.is_grad_enabled() and _build.on_cuda(x, "conv_bn_relu"))


def _folded_conv(conv: Conv, bn: nn.BatchNorm2d, x: torch.Tensor):
    """(conv(x) without its bias, in the compute dtype, the scale, the
    bias) of a folded convolution; the counter ``conv_fold.convs``."""
    dt = conv.compute_dtype or conv.weight.dtype
    x = x.to(dt)
    fmt = torch.channels_last if _build.channels_last(x) else torch.contiguous_format
    w, scale, bias = folded(conv, bn, dt, fmt)
    count("conv_fold.convs")
    return conv._conv_forward(x, w, None), scale, bias


def conv_bn_relu(conv: Conv, bn: nn.BatchNorm2d, x: torch.Tensor, residual=None) -> torch.Tensor:
    """relu(bn(conv(x)) (+ residual)); ``residual`` is None, a tensor, or a
    shortcut (conv_r, bn_r, x_r) whose output bn_r(conv_r(x_r)) is added (a
    BasicBlock's downsample).

    Where every BatchNorm folds (``_folds``: serving, eval on the card) the
    convolution runs on its cached weight (``folded``) and the BatchNorm's
    scale and bias, the residual and the ReLU follow in one pass over its
    output (``ops/epilogue.py: conv_epilogue``), with the unfolded trunk's
    bf16 roundings of the BatchNorm's output and of the sum; a shortcut's
    convolution runs the same way and its output joins that pass with its
    own scale and bias. The counter ``conv_fold.convs`` counts the
    convolutions that ran folded. Elsewhere (training, any forward that
    records gradients, the CPU) the modules run one after the other."""
    shortcut = isinstance(residual, tuple)
    if not (_folds(bn, x) and (not shortcut or _folds(residual[1], x))):
        y = bn(conv(x))
        if shortcut:
            residual = residual[1](residual[0](residual[2]))
        return F.relu(y if residual is None else y + residual)
    y, scale, bias = _folded_conv(conv, bn, x)
    z = z_scale = z_bias = None
    if shortcut:
        z, z_scale, z_bias = _folded_conv(*residual)
    elif residual is not None:
        z = residual
    if z is not None:  # the residual in y's dtype and memory order (a copy only where not)
        z = z.to(y.dtype).contiguous(memory_format=memory_order(y) or torch.contiguous_format)
    return conv_epilogue(y, scale, bias, z, z_scale, z_bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """max_pool2d(kernel=3, stride=2, padding=1), -inf padding."""
    return F.max_pool2d(x, 3, 2, 1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) of NCHW ``x`` to
    ``size`` = (H', W'); an exact 2x upsample goes to the up2x kernel, in
    ``x``'s dtype (f32, or bf16 under a bf16 trunk): a channels-last ``x``
    on the card stays channels-last where autograd records nothing (the
    kernel's NHWC form); otherwise it goes contiguous. A one-pixel map is
    contiguous, so a decoder from a 1x1 layer4 (patch 32) runs NCHW."""
    h, w = x.shape[-2:]
    if tuple(size) == (2 * h, 2 * w):
        keep = (not torch.is_grad_enabled() and _build.channels_last(x)
                and _build.on_cuda(x, "resize_bilinear"))
        return up2x(x if keep else x.contiguous())
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
