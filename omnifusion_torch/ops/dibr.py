"""Depth-image-based rendering helpers (vertical / horizontal baselines).

The port's counterpart of ``omnifusion_tpu/ops/dibr.py``. Parity:
util.py:384-413 — disparity fields from spherical derivatives, coordinate
grids offset by the disparity, then forward-splat rendering. Coordinates and
grids are channel-last.
"""

from __future__ import annotations

import torch

from omnifusion_torch.ops import derivatives as D
from omnifusion_torch.ops.derivatives import _clean
from omnifusion_torch.ops.splatting import render


def dibr_vertical(depth, image, uvgrid, sgrid, baseline, max_depth: float = 8.0):
    """Render the view shifted vertically by ``baseline`` (util.py:384-397).

    depth: (B,H,W,1); image: (B,H,W,C); uvgrid/sgrid: (B,H,W,2).
    """
    disp = torch.cat([torch.zeros_like(depth), D.dtheta_vertical(sgrid, depth, baseline)], -1)
    coords = _clean(uvgrid + disp)
    rendered, _ = render(image, depth, coords, max_depth=max_depth)
    return rendered


def dibr_horizontal(depth, image, uvgrid, sgrid, baseline, max_depth: float = 8.0):
    """Render the view shifted horizontally (util.py:399-413); the u
    coordinate wraps modulo the panorama width (a floor modulo, as
    ``jnp.mod``: a u left of the seam lands at the right edge)."""
    w = image.shape[2]
    disp = torch.cat(
        [
            D.dphi_horizontal_clip(sgrid, depth, baseline),
            D.dtheta_horizontal_clip(sgrid, depth, baseline),
        ],
        dim=-1,
    )
    coords = uvgrid + disp
    coords = torch.cat([torch.remainder(coords[..., 0:1] + w, w), coords[..., 1:2]], dim=-1)
    coords = _clean(coords)
    rendered, _ = render(image, depth, coords, max_depth=max_depth)
    return rendered
