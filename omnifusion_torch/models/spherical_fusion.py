"""Geometry-aware spherical fusion depth network (one-shot).

The port's counterpart of ``omnifusion_tpu/models/spherical_fusion.py``:
ERP -> tangent patches (equi2pers) -> shared ResNet-34 encoder (+ geometric
point features at layer1) -> one channel-major 32*(h/32)*(w/32)-wide token
per patch -> transformer over the patch axis -> U-Net decoder with encoder
skips and five exact-2x upsamples -> fused depth + confidence heads ->
confidence-weighted merge back to ERP (pers2equi).

The trunk runs NCHW with the patch axis folded into the batch. The modules
sit at the upstream checkpoint's flat names (conv1, layer1, ..., down,
transformer, de_conv*, pred, weight_pred, mlp_points; plus up_proj where the
token width is not 512): ``DepthTrunk`` extends ``ResNet34Encoder`` and
``SphericalFusion`` extends ``DepthTrunk``, so a state dict converted from
the JAX variables (models/convert.py) loads with strict=True.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omnifusion_torch.device import resolve_device
from omnifusion_torch.models.layers import (
    ConvBnReLU,
    TorchBatchNorm,
    resize_bilinear,
    torch_conv,
)
from omnifusion_torch.models.resnet import RESNET34_STAGES, ResNet34Encoder
from omnifusion_torch.models.transformer import TransformerCascade
from omnifusion_torch.projection.ops import equi2pers, pers2equi_cf
from omnifusion_torch.projection.spec import (
    Pers2EquiGrids,
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)


class MlpPoints(nn.Sequential):
    """Two 1x1 conv + BN + ReLU geometric embedding (upstream mlp_points:
    Sequential indices 0, 1, 3, 4 hold the parameters)."""

    def __init__(self, in_features: int = 5, hidden: int = 16, out: int = 64, device=None):
        super().__init__(
            torch_conv(in_features, hidden, 1, device=device),
            TorchBatchNorm(hidden, device=device),
            nn.ReLU(),
            torch_conv(hidden, out, 1, device=device),
            TorchBatchNorm(out, device=device),
            nn.ReLU(),
        )


class DepthTrunk(ResNet34Encoder):
    """Shared encoder/transformer/decoder/heads over a folded patch stack.

    ``trunk(x, point_feat, b)``: x (B*P, 3, h, w) and point_feat
    (P, 64, h/4, w/4) -> (pred, conf), each (B*P, 1, h, w).
    """

    def __init__(
        self,
        patch_size: tuple[int, int],
        n_patches: int,
        depth: int = 6,
        num_heads: int = 4,
        encoder_stages: Optional[Sequence[tuple[int, int, int]]] = None,
        device=None,
    ):
        stages = tuple(encoder_stages or RESNET34_STAGES)
        super().__init__(stages, device=device)
        c1, c2, c3, c4 = (s[0] for s in stages)
        hh, ww = patch_size[0] // 32, patch_size[1] // 32
        self.emb = 32 * hh * ww
        self.down = torch_conv(c4, 32, 1, use_bias=True, device=device)
        self.transformer = TransformerCascade(
            self.emb, n_patches, depth=depth, num_heads=num_heads, device=device
        )
        # token elements are re-read as layer4 channels and broadcast over
        # space when emb == layer4's width (patch 128); otherwise the tokens
        # fold back to their source layout through a 1x1 projection
        if self.emb != c4:
            self.up_proj = torch_conv(32, c4, 1, use_bias=True, device=device)
        self.de_conv0_0 = ConvBnReLU(c4, 256, device=device)
        self.de_conv0_1 = ConvBnReLU(256 + c3, 128, device=device)
        self.de_conv1_0 = ConvBnReLU(128, 128, device=device)
        self.de_conv1_1 = ConvBnReLU(128 + c2, 64, device=device)
        self.de_conv2_0 = ConvBnReLU(64, 64, device=device)
        self.de_conv2_1 = ConvBnReLU(64 + c1, 64, device=device)
        self.de_conv3_0 = ConvBnReLU(64, 64, device=device)
        self.de_conv3_1 = ConvBnReLU(64 + 64, 32, device=device)
        self.de_conv4_0 = ConvBnReLU(32, 32, device=device)
        self.pred = torch_conv(32, 1, 3, 1, 1, use_bias=True, device=device)
        self.weight_pred = torch_conv(32, 1, 3, 1, 1, use_bias=True, device=device)

    def trunk(self, x, point_feat, b: int):
        bp, _, h, w = x.shape
        p = bp // b
        pf = point_feat.expand(b, *point_feat.shape).reshape(bp, *point_feat.shape[1:])
        feats = self.encode(x, pf.to(x.dtype))
        conv1, l1, l2, l3, l4 = (
            feats[k] for k in ("conv1", "layer1", "layer2", "layer3", "layer4")
        )

        # global fusion: one channel-major-flattened token per patch
        tok = self.down(l4).reshape(b, p, self.emb)
        tok = self.transformer(tok)
        if self.emb == l4.shape[1]:
            l4 = l4 + tok.reshape(bp, self.emb, 1, 1)
        else:
            hh, ww = l4.shape[-2:]
            l4 = l4 + self.up_proj(tok.reshape(bp, 32, hh, ww))

        def up_stage(x, skip, conv0, conv1):
            x = conv0(resize_bilinear(x, skip.shape[-2:]))
            return conv1(torch.cat([x, skip.to(x.dtype)], dim=1))

        x = up_stage(l4, l3, self.de_conv0_0, self.de_conv0_1)
        x = up_stage(x, l2, self.de_conv1_0, self.de_conv1_1)
        x = up_stage(x, l1, self.de_conv2_0, self.de_conv2_1)
        x = up_stage(x, conv1, self.de_conv3_0, self.de_conv3_1)
        x = self.de_conv4_0(resize_bilinear(x, (h, w)))

        # fused heads: one conv with both heads' kernels reads the feature
        # map once; each head keeps its own parameters
        y = F.conv2d(
            x,
            torch.cat([self.pred.weight, self.weight_pred.weight]),
            torch.cat([self.pred.bias, self.weight_pred.bias]),
            padding=1,
        )
        return F.relu(y[:, :1]), torch.sigmoid(y[:, 1:])


def confidence_merge(pred, conf, p2e_grids: Pers2EquiGrids, dtype=None):
    """Merge per-patch depth to ERP with the confidence-weighted scheme:
    pers2equi(pred*conf) / pers2equi(conf), both in one 2-channel
    channel-first blend.

    pred, conf: (B, P, h, w) or any shape that flattens to (B, P*h*w) in
    patch-major order. dtype: precision of the blend's source (default f32;
    f16 and bf16 allowed); the blend accumulates and the division runs in
    f32. Returns (B, H, W, 1) f32."""
    mdt = torch.float32 if dtype is None else dtype
    b = pred.shape[0]
    pred = pred.to(mdt).reshape(b, -1)
    conf = conf.to(mdt).reshape(b, -1)
    merged = pers2equi_cf(torch.stack([pred * conf, conf], dim=1), p2e_grids)
    num, den = merged[:, 0].float(), merged[:, 1].float()
    zero = (den <= 1e-8).float()
    return (num / (den + 1e-8 * zero))[..., None]


class SphericalFusion(DepthTrunk):
    """One-shot model: ERP (B, H, W, 3) -> depth (B, H, W, 1).

    ``device``: where the parameters live; None means the CUDA card, and
    raises when there is none. Parameters start from PyTorch's default
    init: load a state dict, or call ``init_weights`` for seeded ones."""

    def __init__(
        self,
        spec: ProjectionSpec,
        depth: int = 6,
        num_heads: int = 4,
        encoder_stages: Optional[Sequence[tuple[int, int, int]]] = None,
        merge_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        device = resolve_device(device)
        super().__init__(
            (spec.patch_h, spec.patch_w), spec.n_patches, depth, num_heads,
            encoder_stages, device=device,
        )
        self.spec = spec
        self.merge_dtype = merge_dtype
        self.mlp_points = MlpPoints(device=device)
        # geometric embedding input: (center, rho=1, center) per patch pixel
        # at quarter resolution
        spec_q = spec.with_patch_scale(4)
        centers = spec_q.centers_normalized().astype(np.float32)  # (P, 2)
        geo = np.concatenate([centers, np.ones_like(centers[:, :1]), centers], axis=-1)
        geo = torch.from_numpy(geo)[:, :, None, None].expand(-1, -1, spec_q.patch_h, spec_q.patch_w)
        self.register_buffer("geo", geo.contiguous().to(device), persistent=False)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        if rgb.shape[1:3] != (spec.erp_h, spec.erp_w):
            raise ValueError(f"input {tuple(rgb.shape)} does not match {spec}")
        b, p = rgb.shape[0], spec.n_patches
        h, w = spec.patch_h, spec.patch_w
        patches = equi2pers(rgb, build_equi2pers_grids(spec))  # (B, P, h, w, 3)
        x = patches.permute(0, 1, 4, 2, 3).reshape(b * p, 3, h, w)
        pred, conf = self.trunk(x, self.mlp_points(self.geo), b)
        return confidence_merge(
            pred.reshape(b, p, h, w),
            conf.reshape(b, p, h, w),
            build_pers2equi_grids(spec),
            dtype=self.merge_dtype,
        )


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model``'s parameters from a seeded ``torch.Generator``, with
    the JAX package's initializer families: convs normal with
    std sqrt(2/fan_out), linears Xavier-uniform, pos_emb normal(0.02),
    biases 0, BatchNorm scale 1 and running stats (0, 1). The numbers are
    drawn on the CPU, so one seed gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)

    def fill(t: torch.Tensor, values: torch.Tensor):
        t.copy_(values.to(t.dtype))

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            fill(m.weight, torch.randn(m.weight.shape, generator=g) * (2.0 / fan_out) ** 0.5)
        elif isinstance(m, nn.Linear):
            bound = (6.0 / (m.in_features + m.out_features)) ** 0.5
            fill(m.weight, (torch.rand(m.weight.shape, generator=g) * 2 - 1) * bound)
        elif isinstance(m, TransformerCascade):
            fill(m.pos_emb, torch.randn(m.pos_emb.shape, generator=g) * 0.02)
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
        if isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
    return model
