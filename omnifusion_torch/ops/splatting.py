"""Differentiable forward splatting (bilinear scatter-add), NHWC.

The port's counterpart of ``omnifusion_tpu/ops/splatting.py``. Parity:
supervision/splatting.py in the torch reference (itself derived from
google/layered-scene-inference): bilinear scatter-add splat with a 1e-3
weight threshold, depth-distance weighting 1/exp(2d/max_depth), and
weighted-average normalization.

The scatter is PyTorch's out-of-place ``index_add`` over a flat
``batch * out_h * out_w + target`` index, as the JAX package's is XLA's
``.at[].add``: no kernel of the TPU port stands behind it. Autograd reaches
the values and, through the corner weights, the coordinates; ``floor`` has
a zero gradient. On a CUDA tensor ``index_add`` sums floats with atomics, so
the order of the sums, and the last bits, vary from call to call.
"""

from __future__ import annotations

import torch


def splat(values: torch.Tensor, coords: torch.Tensor, shape_hw) -> torch.Tensor:
    """Bilinear forward-splat ``values`` at float ``coords``.

    values: (B, H, W, C); coords: (B, H, W, 2) as (u, v) target pixel
    coordinates; returns (B, out_h, out_w, C).
    """
    b, h, w, c = values.shape
    out_h, out_w = shape_hw
    u = coords[..., 0]
    v = coords[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    u1 = u0 + 1
    v1 = v0 + 1

    u0s = torch.clamp(u0, 0, out_w - 1)
    u1s = torch.clamp(u1, 0, out_w - 1)
    v0s = torch.clamp(v0, 0, out_h - 1)
    v1s = torch.clamp(v1, 0, out_h - 1)

    # corners that were clamped contribute nothing (splatting.py:26-29)
    u0w = (u1 - u) * (u0 == u0s)
    u1w = (u - u0) * (u1 == u1s)
    v0w = (v1 - v) * (v0 == v0s)
    v1w = (v - v0) * (v1 == v1s)

    base = (torch.arange(b, device=values.device) * (out_h * out_w))[:, None]
    flat_vals = values.reshape(b, h * w, c)
    targets, contribs = [], []
    for uw, us, vw, vs in (
        (u0w, u0s, v0w, v0s),
        (u1w, u1s, v0w, v0s),
        (u0w, u0s, v1w, v1s),
        (u1w, u1s, v1w, v1s),
    ):
        wgt = uw * vw
        wgt = wgt * (wgt >= 1e-3)  # weight threshold (splatting.py:33-38)
        targets.append(base + (us + vs * out_w).long().reshape(b, h * w))
        contribs.append(flat_vals * wgt.reshape(b, h * w, 1))
    out = torch.zeros(b * out_h * out_w, c, dtype=values.dtype, device=values.device)
    out = out.index_add(0, torch.cat(targets, 1).reshape(-1), torch.cat(contribs, 1).reshape(-1, c))
    return out.reshape(b, out_h, out_w, c)


def depth_distance_weights(depth: torch.Tensor, max_depth: float = 20.0) -> torch.Tensor:
    """1 / exp(2 d / max_depth) (splatting.py:71-73)."""
    return 1.0 / torch.exp(2.0 * depth / max_depth)


def weighted_average_splat(value: torch.Tensor, weights: torch.Tensor,
                           epsilon: float = 1e-8) -> torch.Tensor:
    zero = (weights <= epsilon).to(value.dtype)
    return value / (weights + epsilon * zero)


def render(img: torch.Tensor, depth: torch.Tensor, coords: torch.Tensor,
           max_depth: float = 20.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-weighted forward-splat render (splatting.py:76-84).

    Returns (rendered, mask); mask marks pixels that received weight.
    """
    weights = depth_distance_weights(depth, max_depth)
    shape_hw = img.shape[1:3]
    splat_img = splat(img * weights, coords, shape_hw)
    splat_w = splat(weights, coords, shape_hw)
    recon = weighted_average_splat(splat_img, splat_w)
    mask = splat_w > 1e-3
    return recon, mask
