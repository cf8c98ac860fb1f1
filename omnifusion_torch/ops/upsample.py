"""Exact 2x bilinear upsample (half-pixel centres), the decoder's resize.

Replaces the Pallas kernel ``omnifusion_tpu/ops/pallas_resize.py:
_up2x_kernel`` (wrapper ``upsample2x_bilinear``). For scale factor exactly 2
with align_corners=False, the resize is a fixed separable stencil with edge
clamps::

    out[2i]   = 0.25 * in[i-1] + 0.75 * in[i]
    out[2i+1] = 0.75 * in[i]   + 0.25 * in[i+1]

applied along W, then along H, on contiguous NCHW tensors.

- ``up2x``: the wrapper. On a CUDA tensor it launches the CUDA kernel
  (``omnifusion_torch/csrc/up2x.cu``) and adds one to ``up2x.launches``; on
  a CPU tensor it runs ``up2x_plain``; on any other device it raises.
- ``up2x_plain``: the same stencil in plain PyTorch.

Bound on the card: bytes (input + output over 3.35 TB/s). The kernel gives
each output element one thread in output order, so writes coalesce and each
input is read from device memory about once.
"""

from __future__ import annotations

import torch

from omnifusion_torch.ops import _build


def _up2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def up2x_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W) in plain PyTorch, computed in f32."""
    y = _up2x_axis(_up2x_axis(x.float(), 3), 2)
    return y.to(x.dtype)


def up2x(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) contiguous -> (N, C, 2H, 2W), same dtype."""
    if x.device.type == "cpu":
        return up2x_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"up2x runs on cuda or cpu tensors, got {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"up2x: unsupported dtype {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f"up2x: need a contiguous NCHW tensor, got {tuple(x.shape)} "
            f"with strides {x.stride()}"
        )
    n, c, h, w = x.shape
    y = torch.empty(n, c, 2 * h, 2 * w, dtype=x.dtype, device=x.device)
    err = _build.library().omnifusion_up2x(
        x.data_ptr(),
        y.data_ptr(),
        _build.DTYPE_CODES[x.dtype],
        n * c,
        h,
        w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "up2x")
    up2x.launches += 1
    return y


up2x.launches = 0
