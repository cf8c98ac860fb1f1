"""Depth -> surface normals on the sphere, NHWC.

The port's counterpart of ``omnifusion_tpu/ops/depth2normal.py``. Two
estimators with reference parity:
  - ``normals_cross``: 4-neighbor cross-product averaging
    (util.py:332-382, depth2normal_gpu) + curvature map (util.py:376-381).
  - ``normals_plane_fit``: least-squares plane fit over a dilated 5x5
    neighborhood with the closed-form 3x3 inverse of the JAX package (its
    adjugate, and the identity where the Gram matrix's determinant is below
    1e-5; ``torch.linalg.inv`` would give other results near singular
    Gram matrices).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from omnifusion_torch.utils.ply import sphere_xyz


@functools.lru_cache(maxsize=16)
def _sphere_xyz(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(H, W, 3) f32 unit rays of the ERP pixels on ``device``."""
    return torch.from_numpy(sphere_xyz(h, w)).to(device)


def _normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=dim, keepdim=True).clamp_min(eps)


def depth_to_points(depth: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) depth -> (B, H, W, 3) points on the sphere rays."""
    b, h, w, _ = depth.shape
    return _sphere_xyz(h, w, depth.device)[None] * depth


def normals_cross(depth: torch.Tensor, return_curvature: bool = False):
    """Cross-product normals (parity: util.py:332-382).

    depth: (B, H, W, 1) -> normals (B, H, W, 3) unit vectors, and with
    ``return_curvature`` the curvature (B, H, W).
    """
    v = depth_to_points(depth)
    # neighbor differences, zero-padded at the borders (util.py:350-353);
    # F.pad's pairs run from the last dim: (C, W, H)
    vec0 = F.pad(v[:, :, :-1] - v[:, :, 1:], (0, 0, 0, 1))
    vec2 = F.pad(v[:, :-1] - v[:, 1:], (0, 0, 0, 0, 0, 1))
    vec4 = F.pad(v[:, :, 1:] - v[:, :, :-1], (0, 0, 1, 0))
    vec6 = F.pad(v[:, 1:] - v[:, :-1], (0, 0, 0, 0, 1, 0))

    cross = functools.partial(torch.linalg.cross, dim=-1)
    n = _normalize(cross(vec2, vec0))
    n = n + _normalize(cross(vec4, vec2))
    n = n + _normalize(cross(vec6, vec4))
    n = n + _normalize(cross(vec0, vec6))
    n = _normalize(n)
    if not return_curvature:
        return n
    # curvature from normal disagreement (util.py:370-381)
    pad = F.pad(n, (0, 0, 1, 1, 1, 1))
    h = depth.shape[1]
    w = depth.shape[2]
    n1 = pad[:, :h, 1:-1]
    n2 = pad[:, 2:, 1:-1]
    n3 = pad[:, 1:-1, :w]
    n4 = pad[:, 1:-1, 2:]
    cur = (1 - (n1 * n2).sum(-1) / 2) + (1 - (n3 * n4).sum(-1) / 2)
    cur = cur / 2
    cur = torch.where(cur < 1e-6, torch.zeros_like(cur), cur)
    return n, cur


def _inv3x3(m: torch.Tensor):
    """Closed-form 3x3 inverse via the adjugate (batched over leading dims):
    (inverse, determinant)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    adj = torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None], det


def normals_plane_fit(depth: torch.Tensor, kernel_size: int = 5, dilation: int = 2):
    """Least-squares plane-fit normals (parity: equi_pers/depth2normal.py).

    Solves A n = 1 over each (dilated) kxk neighborhood of 3D points; the
    Gram matrix with det < 1e-5 falls back to identity like the reference.
    depth: (B, H, W, 1) -> (B, H, W, 3).
    """
    b, h, w, _ = depth.shape
    pts = depth_to_points(depth)  # (B, H, W, 3)
    k = kernel_size
    pad = k - 1  # reference uses padding=k-1 with dilation=2
    # (B, 3*k*k, H*W), channel-major features, as conv_general_dilated_patches
    patches = F.unfold(pts.permute(0, 3, 1, 2), kernel_size=k, dilation=dilation, padding=pad)
    a = patches.reshape(b, 3, k * k, h, w).permute(0, 3, 4, 2, 1)  # (B, H, W, kk, 3)
    gram = torch.einsum("...ki,...kj->...ij", a, a)
    _, det = _inv3x3(gram)
    eye = torch.eye(3, dtype=gram.dtype, device=gram.device)
    safe = torch.where((det >= 1e-5)[..., None, None], gram, eye)
    inv, _ = _inv3x3(safe)
    atb = a.sum(dim=-2)  # A^T @ ones
    n = torch.einsum("...ij,...j->...i", inv, atb)
    return _normalize(n)
