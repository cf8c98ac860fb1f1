"""Semantic-segmentation spherical fusion.

The port's counterpart of ``omnifusion_tpu/models/segmentation.py``: the
one-shot model's geometry-aware trunk with a ``num_classes``-channel logit
head (no ReLU), the logits merged to ERP with the confidence-weighted
pers2equi blend, and cross-entropy with ignore index -1
(train_erp_sem.py:203 upstream). Under the mesh's model axis the trunk
runs on this model rank's rows and the model group's logits are gathered
before the merge, as in the one-shot model.

The modules sit at the one-shot model's names (``pred`` has
``num_classes`` outputs), so a state dict converted from the JAX
segmentation model's variables (models/convert.py) loads with strict=True.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from omnifusion_torch.device import resolve_device
from omnifusion_torch.models.spherical_fusion import DepthTrunk, MlpPoints, geometry_input
from omnifusion_torch.parallel.mesh import all_reduce_, data_group, data_world
from omnifusion_torch.projection.ops import equi2pers, pers2equi_cf
from omnifusion_torch.projection.spec import (
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)
from omnifusion_torch.utils.profiling import span


class SphericalFusionSeg(DepthTrunk):
    """ERP (B, H, W, 3) -> class logits (B, H, W, num_classes) f32 (f64 for
    an f64 model).

    ``dtype``: the trunk's compute dtype (None: f32; ``torch.bfloat16``: a
    bf16 trunk on f32 parameters, as in ``SphericalFusion``); the logits
    are cast to f32 before the merge, so the merge is f32 either way.
    ``remat``: as in ``SphericalFusion``. ``device``: where the parameters live; None means the CUDA card, and
    raises when there is none. Parameters start from PyTorch's default
    init: load a state dict, or call ``init_weights`` for seeded ones."""

    REPLICATED_INPUT_NORMS = ("mlp_points",)  # as SphericalFusion's

    def __init__(
        self,
        spec: ProjectionSpec,
        num_classes: int = 13,  # the Stanford2D3D semantic classes (utils/iou.py)
        depth: int = 6,
        num_heads: int = 4,
        use_transformer: bool = True,
        dtype: Optional[torch.dtype] = None,
        device=None,
        encoder_stages: Optional[Sequence[tuple[int, int, int]]] = None,
        remat: bool = False,
    ):
        device = resolve_device(device)
        super().__init__(
            (spec.patch_h, spec.patch_w), spec.n_patches, depth, num_heads,
            encoder_stages, dtype=dtype, use_transformer=use_transformer, device=device,
            pred_channels=num_classes, pred_activation="none", remat=remat,
        )
        self.spec = spec
        self.num_classes = num_classes
        self.mlp_points = MlpPoints(dtype=dtype, device=device)
        # the one-shot model's geometric embedding input
        self.register_buffer("geo", geometry_input(spec, device), persistent=False)

    def forward(self, rgb: torch.Tensor, confidence: bool = True) -> torch.Tensor:
        """``confidence=False``: merge the logits alone, unweighted."""
        spec = self.spec
        if rgb.shape[1:3] != (spec.erp_h, spec.erp_w):
            raise ValueError(f"input {tuple(rgb.shape)} does not match {spec}")
        b, p, nc = rgb.shape[0], spec.n_patches, self.num_classes
        h, w = spec.patch_h, spec.patch_w
        with span("model"):
            with span("e2p"):
                if self.dtype is not None:
                    rgb = rgb.to(self.dtype)
                patches = equi2pers(rgb, build_equi2pers_grids(spec))  # (B, P, h, w, 3)
                x = patches.permute(0, 1, 4, 2, 3).reshape(b * p, 3, h, w)
            with span("points"):
                point_feat = self.mlp_points(self.geo)
            heads = self.trunk(x, point_feat, b)
            with span("merge"):
                logits, conf = self.gather_heads(*heads, b)
                # channel-first (B, C, P*h*w) in f32 (segmentation.py:82-83; f64
                # for an f64 model): num and den packed into one merge of C + 1
                # rows per panorama
                mdt = torch.promote_types(logits.dtype, torch.float32)
                lg = logits.to(mdt).reshape(b, p, nc, h * w).transpose(1, 2).reshape(b, nc, -1)
                p2e = build_pers2equi_grids(spec)
                if not confidence:
                    return pers2equi_cf(lg, p2e).permute(0, 2, 3, 1)
                conf = conf.to(mdt).reshape(b, 1, -1)
                merged = pers2equi_cf(torch.cat([lg * conf, conf], dim=1), p2e)  # (B, C+1, H, W)
                num, den = merged[:, :nc], merged[:, nc:]
                zero = (den <= 1e-8).to(den.dtype)
                return (num / (den + 1e-8 * zero)).permute(0, 2, 3, 1)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """Mean cross-entropy over the pixels whose label is not
    ``ignore_index``; 0 where every label is ignored, as the JAX function
    gives (its sum over a count clamped at 1). logits (B, H, W, C); labels
    (B, H, W) integers.

    Under data parallelism the count is the global batch's (an all-reduce
    over the data axis: the model ranks of a data group hold replicas of
    its logits), as the JAX mean over the sharded batch is, and each rank's
    loss is ``data_world * sum / count``: the DDP wrap's average over the
    data axis then gives the gradient of the global mean, and the mean of
    the data groups' losses is that mean."""
    labels = labels.long()
    nll = F.cross_entropy(logits.permute(0, 3, 1, 2), labels, ignore_index=ignore_index,
                          reduction="sum")
    count = all_reduce_((labels != ignore_index).sum().reshape(1), group=data_group())[0]
    return data_world() * nll / count.clamp_min(1)
