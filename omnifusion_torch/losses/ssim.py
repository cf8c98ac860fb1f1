"""SSIM similarity maps, NHWC.

The port's counterpart of ``omnifusion_tpu/losses/ssim.py`` (parity:
supervision/ssim.py). Depthwise convolutions (``F.conv2d`` with one group
per channel) with the outer product of a Gaussian (or a box) window;
images are assumed in [0, 1] (C1/C2 constants as in the reference).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_C1 = 0.01**2
_C2 = 0.03**2


def _gaussian_1d(kernel_size: int, std: float) -> np.ndarray:
    x = np.arange(kernel_size) - kernel_size // 2
    g = np.exp(-(x**2) / (2.0 * std**2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_blur(x: torch.Tensor, window_2d: np.ndarray, padding: int) -> torch.Tensor:
    """x: (B, H, W, C); window_2d: (kh, kw) applied per channel, zero
    padding ``padding`` on each side (0: the valid part)."""
    c = x.shape[-1]
    kernel = torch.from_numpy(np.ascontiguousarray(window_2d)).to(x.device, x.dtype)
    kernel = kernel[None, None].expand(c, 1, *window_2d.shape)
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=padding, groups=c)
    return out.permute(0, 2, 3, 1)


def _ssim_map(pred, gt, blur):
    mu_p = blur(pred)
    mu_g = blur(gt)
    mu_p2 = mu_p.square()
    mu_g2 = mu_g.square()
    mu_pg = mu_p * mu_g
    sigma_p = blur(pred * pred) - mu_p2
    sigma_g = blur(gt * gt) - mu_g2
    cov = blur(pred * gt) - mu_pg
    return ((2 * mu_pg + _C1) * (2 * cov + _C2)) / (
        (mu_p2 + mu_g2 + _C1) * (sigma_p + sigma_g + _C2)
    )


def ssim_gaussian(pred, gt, kernel_size: int = 11, std: float = 1.5):
    """Gaussian-window SSIM map, same spatial size as the input
    (supervision/ssim.py:24-66)."""
    g = _gaussian_1d(kernel_size, std)
    window = np.outer(g, g)
    pad = kernel_size // 2
    return _ssim_map(pred, gt, lambda x: _depthwise_blur(x, window, pad))


def ssim_box(pred, gt, kernel_size: int = 3):
    """Box-window SSIM; interior computed valid then zero-padded back to the
    input size (supervision/ssim.py:68-84)."""
    window = np.full((kernel_size, kernel_size), 1.0 / kernel_size**2, np.float32)
    ssim = _ssim_map(pred, gt, lambda x: _depthwise_blur(x, window, 0))
    pad = kernel_size // 2
    return F.pad(ssim, (0, 0, pad, pad, pad, pad))


def ssim_loss(pred, gt, kernel_size: int = 5, std: float = 1.5, mode: str = "gaussian"):
    if mode == "gaussian":
        return ssim_gaussian(pred, gt, kernel_size=kernel_size, std=std)
    if mode == "box":
        return ssim_box(pred, gt, kernel_size=kernel_size)
    raise ValueError(f"unknown ssim mode {mode!r}")
