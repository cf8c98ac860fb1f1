"""NN building blocks, NCHW.

The port's counterpart of ``omnifusion_tpu/models/layers.py``:

- ``TorchBatchNorm`` is ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``, which the
  JAX module reproduces (biased variance to normalize, unbiased for the
  running stats); inference runs it in eval mode;
- ``torch_conv`` is ``nn.Conv2d`` with symmetric zero padding;
- ``resize_bilinear`` sends an exact 2x upsample to the up2x kernel
  (ops/upsample.py) and any other size to ``F.interpolate``, as the JAX
  function sends it to ``jax.image.resize``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from omnifusion_torch.ops.upsample import up2x


def TorchBatchNorm(features: int, device=None) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1, device=device)


def torch_conv(
    in_features: int,
    features: int,
    kernel_size: int,
    stride: int = 1,
    padding: int = 0,
    use_bias: bool = False,
    device=None,
) -> nn.Conv2d:
    return nn.Conv2d(
        in_features, features, kernel_size, stride=stride, padding=padding,
        bias=use_bias, device=device,
    )


class ConvBnReLU(nn.Module):
    """conv (no bias) -> BN -> ReLU (the upstream ConvBnReLU_v2, with the
    patch axis in the batch)."""

    def __init__(self, in_features, features, kernel_size=3, stride=1, padding=1, device=None):
        super().__init__()
        self.conv = torch_conv(in_features, features, kernel_size, stride, padding, device=device)
        self.bn = TorchBatchNorm(features, device=device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """max_pool2d(kernel=3, stride=2, padding=1), -inf padding."""
    return F.max_pool2d(x, 3, 2, 1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) of NCHW ``x`` to
    ``size`` = (H', W'); an exact 2x upsample goes to the up2x kernel."""
    h, w = x.shape[-2:]
    if tuple(size) == (2 * h, 2 * w):
        return up2x(x.contiguous())
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
