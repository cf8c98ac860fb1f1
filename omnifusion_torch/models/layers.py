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
- ``resize_bilinear`` sends an exact 2x upsample to the up2x kernel
  (ops/upsample.py) and any other size to ``F.interpolate``, as the JAX
  function sends it to ``jax.image.resize``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from omnifusion_torch.ops.upsample import up2x


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
        return F.relu(self.bn(self.conv(x)))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """max_pool2d(kernel=3, stride=2, padding=1), -inf padding."""
    return F.max_pool2d(x, 3, 2, 1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) of NCHW ``x`` to
    ``size`` = (H', W'); an exact 2x upsample goes to the up2x kernel, in
    ``x``'s dtype (f32, or bf16 under a bf16 trunk)."""
    h, w = x.shape[-2:]
    if tuple(size) == (2 * h, 2 * w):
        return up2x(x.contiguous())
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
