"""Spherical disparity/depth derivatives for DIBR, channel-last.

The port's counterpart of ``omnifusion_tpu/ops/derivatives.py``. Parity:
spherical/derivatives.py:28-214. sgrid is (..., 2) as (phi=longitude,
theta=latitude) from omnifusion_torch.geometry.sphere.create_spherical_grid;
depth/disparity are (B, H, W, 1); h below is the image height (max
disparity h = w/2); pcloud is a structured point cloud (B, H, W, 3).
"""

from __future__ import annotations

import math

import torch

from omnifusion_torch.ops.gradients import dI_du, dI_duv, dI_dv


def _phi(sgrid):
    return sgrid[..., 0:1]


def _theta(sgrid):
    return sgrid[..., 1:2]


def _clean(x):
    """NaN and +-inf -> 0."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


# --- spherical-coordinate derivatives w.r.t. cartesian counterparts
#     (spherical/derivatives.py:30-51) ---------------------------------------

def dr_dx(sgrid):
    """Radius distortion for a horizontal baseline (derivatives.py:30-36)."""
    return -torch.cos(_phi(sgrid)) * torch.cos(_theta(sgrid))


def dphi_dx(sgrid):
    """d(longitude)/dx (derivatives.py:38-42)."""
    return torch.sin(_phi(sgrid)) / torch.cos(_theta(sgrid))


def dtheta_dx(sgrid):
    """d(latitude)/dx (derivatives.py:44-47)."""
    return torch.cos(_phi(sgrid)) * torch.sin(_theta(sgrid))


def dtheta_dy(sgrid):
    """d(latitude)/dy (derivatives.py:49-51)."""
    return torch.cos(_theta(sgrid))


def dphi_horizontal_clip(sgrid, depth, baseline):
    h = depth.shape[1]
    dphi = (torch.sin(_phi(sgrid)) / (depth * torch.cos(_theta(sgrid))) * baseline
            * (h / math.pi))
    return _clean(torch.clamp(dphi, -h, h))


def dphi_horizontal(sgrid, depth, baseline):
    """Non-clip variant, offset by +h into [0, 2h] (derivatives.py:73-91)."""
    h = depth.shape[1]
    dphi = (torch.sin(_phi(sgrid)) / (depth * torch.cos(_theta(sgrid))) * baseline
            * (h / math.pi))
    return _clean(h + torch.clamp(dphi, -h, h))


def dtheta_horizontal(sgrid, depth, baseline):
    """Non-clip variant, offset by +h, unclamped (derivatives.py:106-131)."""
    h = depth.shape[1]
    d = torch.cos(_phi(sgrid)) * torch.sin(_theta(sgrid)) * baseline / depth * (h / math.pi)
    return _clean(h + d)


def dtheta_horizontal_clip(sgrid, depth, baseline):
    """Clamped to [0, h] and not cleaned, as in the JAX package: a NaN stays
    a NaN."""
    h = depth.shape[1]
    d = torch.cos(_phi(sgrid)) * torch.sin(_theta(sgrid)) * baseline / depth * (h / math.pi)
    return torch.clamp(d, 0, h)


def dtheta_vertical(sgrid, depth, baseline):
    h = depth.shape[1]
    d = torch.cos(_theta(sgrid)) * baseline / depth * (h / math.pi)
    return _clean(d)


def disparity_to_depth_theta(sgrid, disparity, baseline):
    h = disparity.shape[1]
    d = torch.cos(_phi(sgrid)) * torch.sin(_theta(sgrid)) * baseline / disparity * (h / math.pi)
    return _clean(d)


def disparity_to_depth_vertical(sgrid, disparity, baseline):
    h = disparity.shape[1]
    return torch.cos(_theta(sgrid)) * baseline / disparity * (h / math.pi)


def dr_horizontal(sgrid, baseline):
    return -torch.cos(_phi(sgrid)) * torch.cos(_theta(sgrid)) * baseline


# --- structured point-cloud spatial derivatives (derivatives.py:190-214) ----

def dV_dx(pcloud):
    return dI_duv(pcloud[..., 0:1])


def dV_dy(pcloud):
    return dI_duv(pcloud[..., 1:2])


def dV_dz(pcloud):
    return dI_duv(pcloud[..., 2:3])


def dV_dxyz(pcloud):
    """L2 magnitude of the summed-|grad| pair over x/y/z channels
    (derivatives.py:202-214)."""
    du = sum(torch.abs(dI_du(pcloud[..., i : i + 1])) for i in range(3))
    dv = sum(torch.abs(dI_dv(pcloud[..., i : i + 1])) for i in range(3))
    duv = torch.cat([du, dv], dim=-1)
    return torch.linalg.norm(duv, dim=-1, keepdim=True)
