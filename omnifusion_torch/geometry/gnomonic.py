"""Gnomonic (tangent-plane) projection math, pure numpy, float64.

A copy of ``omnifusion_tpu/geometry/gnomonic.py``: the port keeps its own so
that it never imports the JAX package.

Forward: tangent-plane screen coords -> sphere (lon, lat), the math of
equi_pers/equi2pers_v3.py:95-104 in the torch reference.
Inverse: sphere (lon, lat) -> tangent-plane coords + visibility, the math of
equi_pers/pers2equi_v3.py:109-127.

These run once per configuration at grid-build time (host, float64), never
inside the per-forward compute path.
"""

from __future__ import annotations

import numpy as np


def forward(x: np.ndarray, y: np.ndarray, theta_c: float, phi_c: float):
    """Tangent-plane coords -> sphere angles for a patch centered at
    (theta_c, phi_c) radians.

    x, y: tangent-plane coordinates (radian-scaled screen coords; at the
    patch center x = y = 0).  Returns (lon, lat) in radians; lon is NOT
    wrapped (can exceed +-pi, like the reference's pre-wrap ``lon``).
    """
    rou = np.sqrt(x * x + y * y)
    c = np.arctan(rou)
    sin_c = np.sin(c)
    cos_c = np.cos(c)
    with np.errstate(invalid="ignore"):
        lat = np.arcsin(
            np.clip(cos_c * np.sin(phi_c) + (y * sin_c * np.cos(phi_c)) / rou, -1.0, 1.0)
        )
    lon = theta_c + np.arctan2(
        x * sin_c, rou * np.cos(phi_c) * cos_c - y * np.sin(phi_c) * sin_c
    )
    # rou == 0 is the patch center (0/0 above): the limit is the center itself.
    at_center = rou == 0
    lat = np.where(at_center, phi_c, lat)
    lon = np.where(at_center, theta_c, lon)
    return lon, lat


def inverse(lon: np.ndarray, lat: np.ndarray, theta_c: float, phi_c: float):
    """Sphere angles -> tangent-plane coords for a patch at (theta_c, phi_c).

    Returns (x, y, cos_c) where cos_c > 0 marks the visible hemisphere.
    x, y are radian-scaled tangent coordinates (same scale as ``forward``'s
    inputs).
    """
    dlon = lon - theta_c
    cos_c = np.sin(phi_c) * np.sin(lat) + np.cos(phi_c) * np.cos(lat) * np.cos(dlon)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = (np.cos(lat) * np.sin(dlon)) / cos_c
        y = (
            np.cos(phi_c) * np.sin(lat)
            - np.sin(phi_c) * np.cos(lat) * np.cos(dlon)
        ) / cos_c
    return x, y, cos_c


def screen_to_tangent(s: np.ndarray, fov_deg: float, full_angle_deg: float) -> np.ndarray:
    """Normalized screen coord in [0, 1] -> radian-scaled tangent coord.

    Matches the reference's scaling (equi2pers_v3.py:86-89): the screen coord
    is mapped to [-1, 1], multiplied by pi (lon axis, full_angle 360) or pi/2
    (lat axis, full_angle 180), then by fov/full_angle.
    """
    half = np.pi if full_angle_deg == 360.0 else np.pi / 2.0
    return (s * 2.0 - 1.0) * half * (fov_deg / full_angle_deg)
