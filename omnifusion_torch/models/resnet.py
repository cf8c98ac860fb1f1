"""ResNet-34 encoder, NCHW, patch axis folded into the batch.

The port's counterpart of ``omnifusion_tpu/models/resnet.py``. Module names
follow the upstream checkpoint (conv1/bn1/layer{1..4}.{i}.conv{1,2}/bn{1,2}/
downsample.{0,1}), so a converted state dict loads with strict=True.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from omnifusion_torch.models.layers import TorchBatchNorm, max_pool_3x3_s2, torch_conv
from omnifusion_torch.utils.profiling import span


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 conv-bn-relu, 3x3 conv-bn, residual, relu."""

    def __init__(self, in_features, features, stride=1, dtype=None, device=None):
        super().__init__()
        self.conv1 = torch_conv(in_features, features, 3, stride, 1, dtype=dtype, device=device)
        self.bn1 = TorchBatchNorm(features, device=device)
        self.conv2 = torch_conv(features, features, 3, 1, 1, dtype=dtype, device=device)
        self.bn2 = TorchBatchNorm(features, device=device)
        self.downsample = None
        if stride != 1 or in_features != features:
            self.downsample = nn.Sequential(
                torch_conv(in_features, features, 1, stride, 0, dtype=dtype, device=device),
                TorchBatchNorm(features, device=device),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def resnet_stage(
    in_features, features, num_blocks, stride, dtype=None, device=None
) -> nn.Sequential:
    return nn.Sequential(
        *(
            BasicBlock(
                in_features if i == 0 else features,
                features,
                stride if i == 0 else 1,
                dtype=dtype,
                device=device,
            )
            for i in range(num_blocks)
        )
    )


RESNET34_STAGES: Sequence[tuple[int, int, int]] = (
    (64, 3, 1),
    (128, 4, 2),
    (256, 6, 2),
    (512, 3, 2),
)


class ResNet34Encoder(nn.Module):
    """Stem + 4 stages; returns the multi-scale feature pyramid.

    Input (N, 3, H, W) -> features:
      conv1:  (N, 64, H/2,  W/2)
      layer1: (N, 64, H/4,  W/4)   (after the 3x3/2 maxpool)
      layer2: (N, 128, H/8,  W/8)
      layer3: (N, 256, H/16, W/16)
      layer4: (N, 512, H/32, W/32)

    ``stages`` = (features, blocks, stride) per stage; a smaller override
    keeps the same pyramid with fewer blocks (small tests). ``dtype``: the
    convolutions' compute dtype (None: that of the parameters, f32); the
    BatchNorms return their input's, so every feature is in ``dtype``.
    """

    def __init__(
        self, stages: Sequence[tuple[int, int, int]] = RESNET34_STAGES, dtype=None, device=None
    ):
        super().__init__()
        self.stages = tuple(tuple(s) for s in stages)
        self.conv1 = torch_conv(3, 64, 7, 2, 3, dtype=dtype, device=device)
        self.bn1 = TorchBatchNorm(64, device=device)
        in_features = 64
        for i, (features, blocks, stride) in enumerate(self.stages, start=1):
            self.add_module(
                f"layer{i}", resnet_stage(in_features, features, blocks, stride, dtype, device)
            )
            in_features = features

    def encode(self, x, extra_layer1_features=None) -> dict:
        with span("encoder"):
            feats = {}
            x = F.relu(self.bn1(self.conv1(x)))
            feats["conv1"] = x
            x = max_pool_3x3_s2(x)
            for i in range(1, len(self.stages) + 1):
                x = getattr(self, f"layer{i}")(x)
                if i == 1 and extra_layer1_features is not None:
                    # geometric point features added to layer1
                    x = x + extra_layer1_features
                feats[f"layer{i}"] = x
            return feats

    def forward(self, x, extra_layer1_features=None) -> dict:
        return self.encode(x, extra_layer1_features)
