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
token width is not 512; ``use_transformer=False``, the legacy variant of
network_360d.py:330-335, has no down, transformer or up_proj and sends
layer4 straight to the decoder): ``DepthTrunk`` extends
``ResNet34Encoder`` and ``SphericalFusion`` extends ``DepthTrunk``, so a
state dict converted from the JAX variables (models/convert.py) loads with
strict=True.

Under the mesh's model axis (``parallel/model_axis.py``) each model rank
runs the trunk on its chunk of the folded patch stack: the tokens are
gathered before the transformer and its output sliced back, and pred and
conf are gathered before the merge, which every model rank runs whole.

``dtype=torch.bfloat16`` is the JAX package's serving recipe (bench.py:
163-188): the ERP is cast before equi2pers, so the e2p blend reads bf16;
MlpPoints, the encoder, ``down``, ``up_proj``, the decoder and the fused
heads compute in bf16 on f32 parameters; the BatchNorms normalize in f32
(where autograd records nothing on the card, as one f32 pass after each
convolution with the residual and the ReLU: ``layers.conv_bn_relu``);
the transformer runs in f32 (transformer.py); the merge's precision is
``merge_dtype`` alone and the depth is f32. Parameters stay f32, so state
dicts do not change.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from omnifusion_torch.device import resolve_device
from omnifusion_torch.models.layers import (
    ConvBnReLU,
    TorchBatchNorm,
    conv_bn_relu,
    resize_bilinear,
    torch_conv,
)
from omnifusion_torch.models.resnet import RESNET34_STAGES, ResNet34Encoder
from omnifusion_torch.models.transformer import TransformerCascade
from omnifusion_torch.ops import _build
from omnifusion_torch.ops.heads import OUTPUTS as HEAD_OUTPUTS
from omnifusion_torch.ops.heads import fused_heads, fused_heads_plain
from omnifusion_torch.parallel.model_axis import gather_patches, gather_tokens, shard_rows
from omnifusion_torch.parallel.sync_bn import remat_contexts
from omnifusion_torch.projection.ops import equi2pers, pers2equi_cf
from omnifusion_torch.projection.spec import (
    Pers2EquiGrids,
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)
from omnifusion_torch.utils.profiling import count, span


class MlpPoints(nn.Sequential):
    """Two 1x1 conv + BN + ReLU geometric embedding (upstream mlp_points:
    Sequential indices 0, 1, 3, 4 hold the parameters; the forward runs
    each conv and BN through ``conv_bn_relu``, so the ReLU modules at 2 and 5
    only keep those indices)."""

    def __init__(
        self, in_features: int = 5, hidden: int = 16, out: int = 64, dtype=None, device=None
    ):
        super().__init__(
            torch_conv(in_features, hidden, 1, dtype=dtype, device=device),
            TorchBatchNorm(hidden, device=device),
            nn.ReLU(),
            torch_conv(hidden, out, 1, dtype=dtype, device=device),
            TorchBatchNorm(out, device=device),
            nn.ReLU(),
        )

    def forward(self, x):
        return conv_bn_relu(self[3], self[4], conv_bn_relu(self[0], self[1], x))


class DepthTrunk(ResNet34Encoder):
    """Shared encoder/transformer/decoder/heads over a folded patch stack.

    ``trunk(x, point_feat, b)``: x (B*P, 3, h, w) and point_feat
    (P, 64, h/4, w/4), shared by the batch, or (B*P, 64, h/4, w/4) ->
    (pred (R, pred_channels, h, w), conf (R, 1, h, w)), in ``dtype``
    (None: f32), of this model rank's R rows (``model_axis.shard_rows``;
    all B*P without a model axis); ``trunk_rows`` takes those rows
    already sharded, and ``gather_heads`` gathers the group's heads.
    ``pred_activation``: "relu" (depth) or "none" (segmentation logits).
    The fused heads run on their kernel (``ops/heads.py``) where autograd
    records nothing, and as a cuDNN convolution where it records.
    The token projection sits at ``DOWN``, the upstream checkpoint's name
    for it. ``use_transformer=False``: no global
    fusion (no token projection, transformer or up_proj); layer4 goes
    straight to the decoder. ``remat``: rematerialize the encoder
    (``--remat``): in a forward that records gradients its activations are
    not kept but computed again in the backward, its BatchNorms normalizing
    as in the forward and updating their running statistics once
    (``parallel.remat_contexts``), as the JAX package's
    ``nn.remat(ResNet34Encoder)`` (spherical_fusion.py:115) trades FLOPs for
    memory.
    """

    DOWN = "down"

    def __init__(
        self,
        patch_size: tuple[int, int],
        n_patches: int,
        depth: int = 6,
        num_heads: int = 4,
        encoder_stages: Optional[Sequence[tuple[int, int, int]]] = None,
        dtype: Optional[torch.dtype] = None,
        use_transformer: bool = True,
        device=None,
        pred_channels: int = 1,
        pred_activation: str = "relu",
        remat: bool = False,
    ):
        if pred_activation not in ("relu", "none"):
            raise ValueError(f"pred_activation must be 'relu' or 'none', got {pred_activation!r}")
        stages = tuple(encoder_stages or RESNET34_STAGES)
        super().__init__(stages, dtype=dtype, device=device)
        self.dtype = dtype
        self.n_patches = n_patches
        self.use_transformer = use_transformer
        self.remat = remat
        self.pred_channels = pred_channels
        self.pred_activation = pred_activation
        c1, c2, c3, c4 = (s[0] for s in stages)
        # layer4's side: five stride-2 stages, each rounding up
        hh, ww = -(-patch_size[0] // 32), -(-patch_size[1] // 32)
        self.emb = 32 * hh * ww
        if use_transformer:
            setattr(self, self.DOWN,
                    torch_conv(c4, 32, 1, use_bias=True, dtype=dtype, device=device))
            self.transformer = TransformerCascade(
                self.emb, n_patches, depth=depth, num_heads=num_heads, device=device
            )
            # token elements are re-read as layer4 channels and broadcast over
            # space when emb == layer4's width (patch 128); otherwise the
            # tokens fold back to their source layout through a 1x1 projection
            if self.emb != c4:
                self.up_proj = torch_conv(32, c4, 1, use_bias=True, dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.de_conv0_0 = ConvBnReLU(c4, 256, **kw)
        self.de_conv0_1 = ConvBnReLU(256 + c3, 128, **kw)
        self.de_conv1_0 = ConvBnReLU(128, 128, **kw)
        self.de_conv1_1 = ConvBnReLU(128 + c2, 64, **kw)
        self.de_conv2_0 = ConvBnReLU(64, 64, **kw)
        self.de_conv2_1 = ConvBnReLU(64 + c1, 64, **kw)
        self.de_conv3_0 = ConvBnReLU(64, 64, **kw)
        self.de_conv3_1 = ConvBnReLU(64 + 64, 32, **kw)
        self.de_conv4_0 = ConvBnReLU(32, 32, **kw)
        self.pred = torch_conv(32, pred_channels, 3, 1, 1, use_bias=True, device=device)
        self.weight_pred = torch_conv(32, 1, 3, 1, 1, use_bias=True, device=device)

    def fuse(self, l4, b: int):
        """Global fusion: one channel-major-flattened token per patch; the
        tokens come out of the transformer in f32 (transformer.py) and are
        added to layer4. Under a model axis the transformer runs on the
        model group's tokens, gathered, and this rank keeps its rows.
        Spans: ``transformer`` around it all, ``transformer_blocks`` around
        the ``TransformerCascade`` call, ``up_proj`` around the tokens'
        fold back through ``up_proj`` and the sum (counter
        ``up_proj.calls``), where the token is not layer4's width."""
        with span("transformer"):
            rows, n = l4.shape[0], b * self.n_patches
            tok = gather_tokens(getattr(self, self.DOWN)(l4).reshape(rows, self.emb), n)
            with span("transformer_blocks"):
                tok = self.transformer(tok.reshape(b, self.n_patches, self.emb))
            tok = shard_rows(tok.reshape(n, self.emb))
            if self.emb == l4.shape[1]:
                # bf16 + f32 promotes to f32, as in JAX (spherical_fusion.py:147),
                # so under a bf16 trunk the first decoder upsample runs in f32
                return l4 + tok.reshape(rows, self.emb, 1, 1)
            with span("up_proj"):
                count("up_proj.calls")
                # up_proj computes in the trunk's dtype and the sum keeps it
                # (spherical_fusion.py:151-153). The tokens' map is cast as
                # up_proj's call would cast it, channels-last where layer4 is
                # (not a 1x1 map, which is either), and the sum is put in
                # layer4's order: a channels-last layer4 keeps the decoder
                # channels-last whichever operand came out in which order
                hh, ww = l4.shape[-2:]
                fmt = torch.channels_last if _build.channels_last(l4) else torch.contiguous_format
                t = tok.reshape(rows, 32, hh, ww).to(l4.dtype, memory_format=fmt)
                return (l4 + self.up_proj(t)).contiguous(memory_format=fmt)

    def trunk(self, x, point_feat, b: int):
        bp = x.shape[0]
        pf = point_feat
        if pf.shape[0] != bp:  # one per patch, shared by the batch
            pf = pf.expand(b, *pf.shape).reshape(bp, *pf.shape[1:])
        return self.trunk_rows(shard_rows(x), shard_rows(pf), b)

    def trunk_rows(self, x, pf, b: int):
        """The trunk on this model rank's rows of the folded patch stack of
        ``b`` panoramas: x (R, 3, h, w), pf (R, 64, h/4, w/4)."""
        h, w = x.shape[-2:]
        if self.dtype is not None:
            x = x.to(self.dtype)
        pf = pf.to(x.dtype)
        if self.remat and torch.is_grad_enabled():
            # the encoder draws no random numbers: no RNG state to keep
            encoder = [self.bn1] + [getattr(self, f"layer{i}") for i in range(1, len(self.stages) + 1)]
            feats = checkpoint(self.encode, x, pf, use_reentrant=False, preserve_rng_state=False,
                               context_fn=lambda: remat_contexts(encoder))
        else:
            feats = self.encode(x, pf)
        conv1, l1, l2, l3, l4 = (
            feats[k] for k in ("conv1", "layer1", "layer2", "layer3", "layer4")
        )

        if self.use_transformer:
            l4 = self.fuse(l4, b)

        def up_stage(x, skip, conv0, conv1):
            x = conv0(resize_bilinear(x, skip.shape[-2:]))
            return conv1(torch.cat([x, skip.to(x.dtype)], dim=1))

        with span("decoder"):
            x = up_stage(l4, l3, self.de_conv0_0, self.de_conv0_1)
            x = up_stage(x, l2, self.de_conv1_0, self.de_conv1_1)
            x = up_stage(x, l1, self.de_conv2_0, self.de_conv2_1)
            x = up_stage(x, conv1, self.de_conv3_0, self.de_conv3_1)
            x = self.de_conv4_0(resize_bilinear(x, (h, w)))

        # fused heads: one conv with both heads' kernels reads the feature
        # map once; each head keeps its own parameters, cast to the feature
        # map's dtype (spherical_fusion.py:174-175). Where autograd records
        # nothing (serving, eval) and the kernel is built for the heads'
        # output count, the heads kernel; where it records, the conv that
        # cuDNN differentiates
        with span("heads"):
            params = (self.pred.weight, self.pred.bias, self.weight_pred.weight,
                      self.weight_pred.bias, self.pred_activation)
            if torch.is_grad_enabled() or self.pred_channels + 1 not in HEAD_OUTPUTS:
                return fused_heads_plain(x, *params)
            return fused_heads(x, *params)

    def gather_heads(self, pred, conf, b: int):
        """The model group's (pred, conf) rows of the ``b`` panoramas, for a
        merge that every model rank runs whole (``model_axis.gather_patches``);
        this rank's own without a model axis."""
        n = b * self.n_patches
        return gather_patches(pred, n), gather_patches(conf, n)


def confidence_merge(
    pred, conf, p2e_grids: Pers2EquiGrids, use_confidence: bool = True, dtype=None
):
    """Merge per-patch depth to ERP with the confidence-weighted scheme:
    pers2equi(pred*conf) / pers2equi(conf), both in one 2-channel
    channel-first blend; with ``use_confidence=False``, pers2equi(pred)
    alone, a 1-channel blend.

    pred, conf: (B, P, h, w) or any shape that flattens to (B, P*h*w) in
    patch-major order. dtype: precision of the blend's source (default f32;
    f16 and bf16 allowed); the blend accumulates and the division runs in
    f32 (f64 throughout for f64 heads). Returns (B, H, W, 1) f32 (f64)."""
    mdt = torch.promote_types(pred.dtype, torch.float32) if dtype is None else dtype
    b = pred.shape[0]
    if not use_confidence:
        spec = p2e_grids.spec
        merged = pers2equi_cf(pred.to(mdt).reshape(b, 1, -1), p2e_grids)
        return merged.reshape(b, spec.erp_h, spec.erp_w, 1)
    pred = pred.to(mdt).reshape(b, -1)
    conf = conf.to(mdt).reshape(b, -1)
    merged = pers2equi_cf(torch.stack([pred * conf, conf], dim=1), p2e_grids)
    num, den = merged[:, 0], merged[:, 1]
    zero = (den <= 1e-8).to(den.dtype)
    return (num / (den + 1e-8 * zero))[..., None]


def geometry_input(spec: ProjectionSpec, device) -> torch.Tensor:
    """The geometric embedding's input, (P, 5, h/4, w/4): (center, rho=1,
    center) per patch pixel at quarter resolution."""
    spec_q = spec.with_patch_scale(4)
    centers = spec_q.centers_normalized().astype(np.float32)  # (P, 2)
    geo = np.concatenate([centers, np.ones_like(centers[:, :1]), centers], axis=-1)
    geo = torch.from_numpy(geo)[:, :, None, None].expand(-1, -1, spec_q.patch_h, spec_q.patch_w)
    return geo.contiguous().to(device)


class SphericalFusion(DepthTrunk):
    """One-shot model: ERP (B, H, W, 3) -> depth (B, H, W, 1) f32.

    ``dtype``: the trunk's compute dtype (None: f32; ``torch.bfloat16``:
    the serving recipe, see the module's docstring). ``merge_dtype``: the
    merge blend's source precision (None: f32). ``use_transformer`` and
    ``remat``: as in ``DepthTrunk`` (``--no_transformer``, ``--remat``).
    ``device``: where the
    parameters live; None means the CUDA card, and raises when there is
    none. Parameters start from PyTorch's default init: load a state dict,
    or call ``init_weights`` for seeded ones."""

    # BatchNorms whose input is the same on every rank of a data-parallel
    # run (the embedding of the patch geometry, shared by the batch): their
    # statistics stay this process's (parallel/ddp.py)
    REPLICATED_INPUT_NORMS = ("mlp_points",)

    def __init__(
        self,
        spec: ProjectionSpec,
        depth: int = 6,
        num_heads: int = 4,
        encoder_stages: Optional[Sequence[tuple[int, int, int]]] = None,
        dtype: Optional[torch.dtype] = None,
        merge_dtype: Optional[torch.dtype] = None,
        use_transformer: bool = True,
        device=None,
        remat: bool = False,
    ):
        device = resolve_device(device)
        super().__init__(
            (spec.patch_h, spec.patch_w), spec.n_patches, depth, num_heads,
            encoder_stages, dtype=dtype, use_transformer=use_transformer, device=device,
            remat=remat,
        )
        self.spec = spec
        self.merge_dtype = merge_dtype
        self.mlp_points = MlpPoints(dtype=dtype, device=device)
        self.register_buffer("geo", geometry_input(spec, device), persistent=False)

    def forward(self, rgb: torch.Tensor, confidence: bool = True) -> torch.Tensor:
        """``confidence=False``: merge the depth alone, unweighted."""
        spec = self.spec
        if rgb.shape[1:3] != (spec.erp_h, spec.erp_w):
            raise ValueError(f"input {tuple(rgb.shape)} does not match {spec}")
        b, p = rgb.shape[0], spec.n_patches
        h, w = spec.patch_h, spec.patch_w
        with span("model"):
            with span("e2p"):
                # cast before the projection, so that the e2p blend reads the
                # trunk's dtype (spherical_fusion.py:264-266)
                if self.dtype is not None:
                    rgb = rgb.to(self.dtype)
                patches = equi2pers(rgb, build_equi2pers_grids(spec))  # (B, P, h, w, 3)
                x = patches.permute(0, 1, 4, 2, 3).reshape(b * p, 3, h, w)
            with span("points"):
                point_feat = self.mlp_points(self.geo)
            heads = self.trunk(x, point_feat, b)
            with span("merge"):
                pred, conf = self.gather_heads(*heads, b)
                return confidence_merge(
                    pred.reshape(b, p, h, w),
                    conf.reshape(b, p, h, w),
                    build_pers2equi_grids(spec),
                    use_confidence=confidence,
                    dtype=self.merge_dtype,
                )


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal draws cut at two standard deviations (each one past
    them drawn again), the distribution of flax's truncated_normal."""
    x = rng.standard_normal(shape)
    while (out := np.abs(x) > 2).any():
        x[out] = rng.standard_normal(int(out.sum()))
    return x


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model``'s parameters from ``np.random.default_rng(seed)``, with
    the JAX package's initializer families: convs normal with std
    sqrt(2/fan_out), linears Xavier-uniform, pos_emb normal(0.02) cut at two
    standard deviations, biases 0, BatchNorm scale 1 and running stats
    (0, 1). One seed gives the same weights on every device and with every
    torch version; torch's own generators do not keep their streams from
    one version to the next."""
    rng = np.random.default_rng(seed)

    def fill(t: torch.Tensor, values: np.ndarray):
        t.copy_(torch.from_numpy(values.astype(np.float32)))

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            fill(m.weight, rng.standard_normal(tuple(m.weight.shape)) * (2.0 / fan_out) ** 0.5)
        elif isinstance(m, nn.Linear):
            bound = (6.0 / (m.in_features + m.out_features)) ** 0.5
            fill(m.weight, rng.uniform(-bound, bound, tuple(m.weight.shape)))
        elif isinstance(m, TransformerCascade):
            fill(m.pos_emb, _truncated_normal(rng, tuple(m.pos_emb.shape)) * 0.02)
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
        if isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
    return model
