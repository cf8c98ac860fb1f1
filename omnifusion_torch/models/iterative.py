"""Iterative-refinement spherical fusion model.

The port's counterpart of ``omnifusion_tpu/models/iterative.py``
(upstream model/spherical_model_iterative.py:253-456). The first pass embeds
the unit-sphere coordinates of the quarter-resolution patch pixels
(``mlp_points1``); each refinement pass projects the previous ERP depth
into quarter-resolution patches (equi2pers, f32), scales the unit-sphere
coordinates by it to 3-D points, embeds them (``mlp_points2``) and runs the
SAME trunk again. Returns the per-pass ERP depths.

The modules sit at the upstream iterative checkpoint's flat names: the
trunk's (conv1, layer1, ..., transformer, de_conv*, pred, weight_pred; plus
up_proj where the token width is not 512), with the token projection at
``down1``, and ``mlp_points1``, ``mlp_points2``: the keys
``omnifusion_tpu/models/torch_export.py: export_iterative_checkpoint``
writes, so a state dict converted from the JAX variables
(models/convert.py) loads with strict=True.

``dtype`` and ``merge_dtype`` are the one-shot model's bf16 recipe
(models/spherical_fusion.py). The feedback depth is the merge's f32 output,
so the quarter-resolution equi2pers reads and stores f32, as in JAX. No
stop-gradient: in training the loss of every later pass reaches the
earlier passes through the feedback.

Under the mesh's model axis (``parallel/model_axis.py``) each pass runs the
trunk on this model rank's rows and merges the model group's gathered
patches, as the one-shot model does; the feedback depth is projected whole
and each rank embeds its own rows (``mlp_points2`` on the local rows, so
that its global BatchNorms count each row once). Each rank's next pass
differentiates only its rows of that depth: its cotangent is summed over
the model group (``sum_cotangent``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from omnifusion_torch.device import resolve_device
from omnifusion_torch.models.spherical_fusion import DepthTrunk, MlpPoints, confidence_merge
from omnifusion_torch.parallel.model_axis import shard_rows, sum_cotangent
from omnifusion_torch.projection.ops import equi2pers
from omnifusion_torch.projection.spec import (
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)
from omnifusion_torch.utils.profiling import span


class SphericalFusionIterative(DepthTrunk):
    """ERP (B, H, W, 3) -> list of ``num_iters`` depth maps (B, H, W, 1) f32.

    ``dtype``, ``merge_dtype``, ``use_transformer``, ``device``,
    ``encoder_stages`` and ``remat`` (each pass's encoder) as in
    ``SphericalFusion``. Parameters start from PyTorch's default init: load
    a state dict, or call ``init_weights`` for seeded ones."""

    DOWN = "down1"
    # the first pass embeds the unit sphere, the same on every rank of a
    # data-parallel run: those statistics stay this process's (parallel/ddp.py)
    REPLICATED_INPUT_NORMS = ("mlp_points1",)

    def __init__(
        self,
        spec: ProjectionSpec,
        num_iters: int = 2,
        depth: int = 6,
        num_heads: int = 4,
        encoder_stages: Optional[Sequence[tuple[int, int, int]]] = None,
        dtype: Optional[torch.dtype] = None,
        merge_dtype: Optional[torch.dtype] = None,
        use_transformer: bool = True,
        device=None,
        remat: bool = False,
    ):
        if num_iters < 1:
            raise ValueError(f"num_iters must be at least 1, got {num_iters}")
        device = resolve_device(device)
        super().__init__(
            (spec.patch_h, spec.patch_w), spec.n_patches, depth, num_heads,
            encoder_stages, dtype=dtype, use_transformer=use_transformer, device=device,
            remat=remat,
        )
        self.spec = spec
        self.spec_q = spec.with_patch_scale(4)
        self.num_iters = num_iters
        self.merge_dtype = merge_dtype
        self.mlp_points1 = MlpPoints(in_features=3, dtype=dtype, device=device)
        self.mlp_points2 = MlpPoints(in_features=3, dtype=dtype, device=device)
        # unit-sphere coordinates of the quarter-resolution patch pixels
        xyz = torch.from_numpy(build_equi2pers_grids(self.spec_q).xyz)  # (P, h/4, w/4, 3)
        self.register_buffer("xyz", xyz.permute(0, 3, 1, 2).contiguous().to(device),
                             persistent=False)

    def unused_parameters(self) -> list[str]:
        """The parameters that no forward uses: with one pass, the
        refinement's embedding (mlp_points2), kept for the state dict."""
        if self.num_iters > 1:
            return []
        return [n for n, _ in self.named_parameters() if n.startswith("mlp_points2.")]

    def forward(self, rgb: torch.Tensor, confidence: bool = False) -> list[torch.Tensor]:
        """``confidence=True``: merge each pass confidence-weighted, as the
        one-shot model does; by default the depth alone, unweighted
        (iterative.py:54 of the JAX package)."""
        spec, spec_q = self.spec, self.spec_q
        if rgb.shape[1:3] != (spec.erp_h, spec.erp_w):
            raise ValueError(f"input {tuple(rgb.shape)} does not match {spec}")
        b, p = rgb.shape[0], spec.n_patches
        h, w = spec.patch_h, spec.patch_w
        with span("model"):
            p2e = build_pers2equi_grids(spec)
            grids_q = build_equi2pers_grids(spec_q)
            with span("e2p"):
                if self.dtype is not None:
                    rgb = rgb.to(self.dtype)
                patches = equi2pers(rgb, build_equi2pers_grids(spec))  # (B, P, h, w, 3)
                x = patches.permute(0, 1, 4, 2, 3).reshape(b * p, 3, h, w)

            def merge(heads):
                with span("merge"):
                    pred, conf = self.gather_heads(*heads, b)
                    return confidence_merge(pred.reshape(b, p, h, w), conf.reshape(b, p, h, w),
                                            p2e, use_confidence=confidence,
                                            dtype=self.merge_dtype)

            # pass 1: the unit sphere, embedded once for all the batch
            with span("points"):
                point_feat = self.mlp_points1(self.xyz)
            preds = [merge(self.trunk(x, point_feat, b))]
            x = shard_rows(x)
            for _ in range(self.num_iters - 1):
                with span("points"):
                    depth = equi2pers(sum_cotangent(preds[-1]), grids_q)  # (B, P, h/4, w/4, 1) f32
                    points = self.xyz * depth.permute(0, 1, 4, 2, 3)  # (B, P, 3, h/4, w/4)
                    points = shard_rows(points.reshape(b * p, 3, spec_q.patch_h, spec_q.patch_w))
                    point_feat = self.mlp_points2(points)
                preds.append(merge(self.trunk_rows(x, point_feat, b)))
            return preds
