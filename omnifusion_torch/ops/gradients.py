"""Image gradient operators, NHWC.

The port's counterpart of ``omnifusion_tpu/ops/gradients.py``. Parity:
spherical/derivatives.py:7-24 (forward differences with replicate padding)
and util.py:415-451 (Sobel gradients).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dI_du(img: torch.Tensor) -> torch.Tensor:
    """Horizontal forward difference, replicate-padded right."""
    padded = torch.cat([img, img[:, :, -1:]], dim=2)
    return padded[:, :, :-1] - padded[:, :, 1:]


def dI_dv(img: torch.Tensor) -> torch.Tensor:
    """Vertical forward difference, replicate-padded bottom."""
    padded = torch.cat([img, img[:, -1:]], dim=1)
    return padded[:, :-1] - padded[:, 1:]


def dI_duv(img: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude over the (du, dv) pair per channel-stack."""
    duv = torch.cat([dI_du(img), dI_dv(img)], dim=-1)
    return torch.linalg.norm(duv, dim=-1, keepdim=True)


SOBEL_X = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
SOBEL_Y = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32)


def _conv3(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """A 3x3 cross-correlation of a (B, H, W, 1) image, zero padding 1."""
    k = torch.from_numpy(kernel).to(img.device, img.dtype)[None, None]
    return F.conv2d(img.permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)


def imgrad(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel (grad_y, grad_x) of the channel-mean image (util.py:426-446).

    img: (B, H, W, C) -> two (B, H, W, 1) maps.
    """
    gray = img.mean(dim=-1, keepdim=True)
    return _conv3(gray, SOBEL_Y), _conv3(gray, SOBEL_X)


def imgrad_yx(img: torch.Tensor) -> torch.Tensor:
    """Stacked (grad_y, grad_x) (util.py:448-451): (B, H, W, 2)."""
    gy, gx = imgrad(img)
    return torch.cat([gy, gx], dim=-1)


def get_sobel_kernel(k: int = 3) -> np.ndarray:
    """Generalized Sobel kernel (util.py:415-424)."""
    rng = np.linspace(-(k // 2), k // 2, k)
    x, y = np.meshgrid(rng, rng)
    denom = x**2 + y**2
    denom[:, k // 2] = 1.0
    return x / denom


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    ax = np.linspace(-(size - 1) / 2.0, (size - 1) / 2.0, size)
    return np.exp(-0.5 * np.square(ax) / np.square(sigma))


def gaussian_kernel_3d(size: int, sigma: float) -> np.ndarray:
    ax = np.linspace(-(size - 1) / 2.0, (size - 1) / 2.0, size)
    xx, yy, zz = np.meshgrid(ax, ax, ax)
    return np.exp(-0.5 * (xx**2 + yy**2 + zz**2) / np.square(sigma))
