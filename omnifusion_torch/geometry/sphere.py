"""Spherical coordinate math (pure functions, numpy and torch twins).

The port's copy of ``omnifusion_tpu/geometry/sphere.py``, with torch in
place of jax.numpy. Parity targets: util.py:159-199 (coords2uv / uv2xyz /
xyz2uv / uv2coords) and spherical/{grid,cartesian,weights}.py in the torch
reference.

Conventions: uv = (longitude u, latitude v) in radians; xyz is a unit-sphere
point with x = cos(v) sin(u), y = cos(v) cos(u), z = sin(v) (the reference's
uv2xyz, util.py:169-174). The torch functions compute in their input's
dtype on its device; the numpy ones in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# numpy versions (used at grid-build time, float64 for accuracy)
# ---------------------------------------------------------------------------

def coords2uv_np(coords: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pixel coords (..., 2) [x, y] -> uv radians; matches util.py:159-166."""
    uv = np.zeros_like(coords, dtype=np.float64)
    middle_x = w / 2 + 0.5
    middle_y = h / 2 + 0.5
    uv[..., 0] = (coords[..., 0] - middle_x) / w * 2 * np.pi
    uv[..., 1] = -(coords[..., 1] - middle_y) / h * np.pi
    return uv


def uv2xyz_np(uv: np.ndarray) -> np.ndarray:
    """uv radians (..., 2) -> unit xyz (..., 3); matches util.py:169-174."""
    xyz = np.zeros((*uv.shape[:-1], 3), dtype=np.float64)
    cos_v = np.cos(uv[..., 1])
    xyz[..., 0] = cos_v * np.sin(uv[..., 0])
    xyz[..., 1] = cos_v * np.cos(uv[..., 0])
    xyz[..., 2] = np.sin(uv[..., 1])
    return xyz


# ---------------------------------------------------------------------------
# torch versions
# ---------------------------------------------------------------------------

def coords2uv(coords: torch.Tensor, w: int, h: int) -> torch.Tensor:
    middle_x = w / 2 + 0.5
    middle_y = h / 2 + 0.5
    u = (coords[..., 0] - middle_x) / w * 2 * math.pi
    v = -(coords[..., 1] - middle_y) / h * math.pi
    return torch.stack([u, v], dim=-1)


def uv2xyz(uv: torch.Tensor) -> torch.Tensor:
    cos_v = torch.cos(uv[..., 1])
    return torch.stack(
        [cos_v * torch.sin(uv[..., 0]), cos_v * torch.cos(uv[..., 0]), torch.sin(uv[..., 1])],
        dim=-1,
    )


def xyz2uv(xyz: torch.Tensor) -> torch.Tensor:
    """xyz (..., 3) -> uv radians (..., 2); matches util.py:177-191.

    u is measured from the +y axis and unwrapped into (-pi, pi]; NaNs from
    degenerate points are zeroed like the reference.
    """
    norm_xy = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2).clamp_min(1e-6)
    norm_xyz = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2 + xyz[..., 2] ** 2)
    v = torch.arcsin(xyz[..., 2] / norm_xyz)
    u = torch.arcsin(torch.clamp(xyz[..., 0] / norm_xy, -1.0, 1.0))
    back = xyz[..., 1] < 0
    u = torch.where(back & (u >= 0), math.pi - u, u)
    u = torch.where(back & (u <= 0), -math.pi - u, u)
    uv = torch.stack([u, v], dim=-1)
    return torch.where(torch.isnan(uv), torch.zeros_like(uv), uv)


def uv2coords(uv: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """uv radians -> pixel coords; matches util.py:193-199."""
    x = (uv[..., 0] + math.pi) / (2 * math.pi) * w + 0.5
    y = (math.pi / 2 - uv[..., 1]) / math.pi * h + 0.5
    return torch.stack([x.clamp_max(float(w)), y.clamp_max(float(h))], dim=-1)


# ---------------------------------------------------------------------------
# ERP grids (spherical/grid.py parity, channel-last)
# ---------------------------------------------------------------------------

def create_image_grid(width: int, height: int) -> np.ndarray:
    """Integer pixel grid, shape (H, W, 2) as (u, v); spherical/grid.py:4-24."""
    u = np.arange(width, dtype=np.float64)[None, :].repeat(height, 0)
    v = np.arange(height, dtype=np.float64)[:, None].repeat(width, 1)
    return np.stack([u, v], axis=-1)


def create_spherical_grid(
    width: int,
    horizontal_shift: float = -np.pi - np.pi / 2.0,
    vertical_shift: float = -np.pi / 2.0,
) -> np.ndarray:
    """Spherical ERP grid, shape (H, W, 2) as (phi, theta).

    Matches spherical/grid.py:27-45: H = W // 2, phi spans
    [hs, 2*pi + hs) and theta spans [vs, pi + vs).
    """
    height = int(width // 2)
    u = np.arange(width, dtype=np.float64) * (2 * np.pi / width) + horizontal_shift
    v = np.arange(height, dtype=np.float64) * (np.pi / height) + vertical_shift
    phi = u[None, :].repeat(height, 0)
    theta = v[:, None].repeat(width, 1)
    return np.stack([phi, theta], axis=-1)


def spherical_confidence(sgrid: torch.Tensor, zero_low: float = 0.0,
                         one_high: float = 1.0) -> torch.Tensor:
    """Pole/seam fade weights; matches spherical/weights.py:5-14.

    sgrid: (..., 2) as (phi, theta).
    """
    w = torch.abs(torch.sin(sgrid[..., 0])) * torch.abs(torch.cos(sgrid[..., 1]))
    w = torch.where(w < zero_low, torch.zeros_like(w), w)
    return torch.where(w > one_high, torch.ones_like(w), w)


def coords_3d(sgrid: torch.Tensor, depth) -> torch.Tensor:
    """Spherical grid + depth -> cartesian points (..., 3).

    Matches spherical/cartesian.py:15-44 (x right, y up, z forward with the
    reference's grid offsets):
      x = -d cos(phi) cos(theta), y = d sin(theta), z = d cos(theta) sin(phi).
    sgrid: (..., 2); depth: broadcastable to sgrid[..., 0].
    """
    phi = sgrid[..., 0]
    theta = sgrid[..., 1]
    x = depth * torch.cos(phi) * -torch.cos(theta)
    y = depth * torch.sin(theta)
    z = depth * torch.sin(phi) * torch.cos(theta)
    return torch.stack([x, y, z], dim=-1)
