"""Exact 2x bilinear upsample (half-pixel centres), the decoder's resize, and
its adjoint, the resize's backward.

Replaces the Pallas kernel ``omnifusion_tpu/ops/pallas_resize.py:
_up2x_kernel`` (wrapper ``upsample2x_bilinear``) and the XLA adjoint its
custom VJP borrows (pallas_resize.py:151-173; in training the JAX models
default to ``models/layers.py:_up2x_conv``, the same function). For scale
factor exactly 2 with align_corners=False, the resize is a fixed separable
stencil with edge clamps::

    out[2i]   = 0.25 * in[i-1] + 0.75 * in[i]
    out[2i+1] = 0.75 * in[i]   + 0.25 * in[i+1]

applied along W, then along H, on contiguous NCHW tensors. Per axis, its
adjoint on a side of n inputs is::

    gx[i] = 0.75 * (g[2i] + g[2i+1]) + 0.25 * (g[2i-1] + g[2i+2])

where a tap past an edge is dropped and the border rows add back the
clamped tap: gx[0] += 0.25 * g[0], gx[n-1] += 0.25 * g[2n-1] (n = 1:
gx[0] = g[0] + g[1]).

- ``up2x``: the differentiable wrapper, an ``autograd.Function`` whose
  backward is ``up2x_adjoint``. Its forward launches the CUDA kernel
  (``omnifusion_torch/csrc/up2x.cu``) on a CUDA tensor and adds one to
  ``up2x.launches``; on a CPU tensor it runs ``up2x_plain``; on any other
  device it raises.
- ``up2x_adjoint``: the adjoint. On a CUDA tensor it launches its kernel
  (same source) and adds one to ``up2x_adjoint.launches``; on a CPU tensor
  it runs ``up2x_adjoint_plain``.
- ``up2x_plain``, ``up2x_adjoint_plain``: the same stencils in plain
  PyTorch, which autograd never differentiates.

Bound on the card, both directions: bytes (input + output over 3.35 TB/s).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from omnifusion_torch.ops import _build

# csrc/up2x.cu's adjoint block per thread: kAdjRows x kAdjCols outputs
ADJOINT_BLOCK = (1, 4)


def _up2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def _adjoint_axis(g: torch.Tensor, dim: int) -> torch.Tensor:
    n = g.shape[dim] // 2
    pairs = g.unflatten(dim, (n, 2))
    even, odd = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)  # g[2i], g[2i+1]
    # g[2i-1], and at i = 0 the clamped tap g[0] in its place; g[2i+2], and
    # at i = n-1 the clamped tap g[2n-1] in its place
    left = torch.cat([even.narrow(dim, 0, 1), odd.narrow(dim, 0, n - 1)], dim)
    right = torch.cat([even.narrow(dim, 1, n - 1), odd.narrow(dim, n - 1, 1)], dim)
    return 0.75 * (even + odd) + 0.25 * (left + right)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the stencils compute in: f32, or f64 for f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def up2x_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W) in plain PyTorch, computed in f32
    (f64 for an f64 input)."""
    y = _up2x_axis(_up2x_axis(_acc(x), 3), 2)
    return y.to(x.dtype)


def up2x_adjoint_plain(g: torch.Tensor) -> torch.Tensor:
    """(N, C, 2H, 2W) -> (N, C, H, W): the adjoint of ``up2x_plain`` in
    plain PyTorch, computed in f32 (f64 for an f64 input)."""
    x = _adjoint_axis(_adjoint_axis(_acc(g), 2), 3)
    return x.to(g.dtype)


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous NCHW tensor, got {tuple(x.shape)} "
            f"with strides {x.stride()}"
        )


def _up2x_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch the forward of csrc/up2x.cu."""
    _check_cuda(x, "up2x")
    n, c, h, w = x.shape
    # the kernel's in-plane offsets and thread index are 32-bit
    if 4 * h * w >= 2**31 or n * c * h * -(-w // 2) >= 2**31:
        raise ValueError(f"up2x: {tuple(x.shape)} is past the kernel's 32-bit plane or thread index")
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


def _adjoint_kernel(g: torch.Tensor) -> torch.Tensor:
    """Launch the adjoint of csrc/up2x.cu."""
    _check_cuda(g, "up2x_adjoint")
    n, c, h2, w2 = g.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"up2x_adjoint: odd spatial shape {tuple(g.shape)}")
    rows, cols = ADJOINT_BLOCK
    # the kernel's in-plane offsets and thread index are 32-bit
    if h2 * w2 >= 2**31 or n * c * -(-h2 // (2 * rows)) * -(-w2 // (2 * cols)) >= 2**31:
        raise ValueError(
            f"up2x_adjoint: {tuple(g.shape)} is past the kernel's 32-bit plane or thread index"
        )
    x = torch.empty(n, c, h2 // 2, w2 // 2, dtype=g.dtype, device=g.device)
    err = _build.library().omnifusion_up2x_adjoint(
        g.data_ptr(),
        x.data_ptr(),
        _build.DTYPE_CODES[g.dtype],
        n * c,
        h2 // 2,
        w2 // 2,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "up2x_adjoint")
    up2x_adjoint.launches += 1
    return x


def up2x_adjoint(g: torch.Tensor) -> torch.Tensor:
    """(N, C, 2H, 2W) contiguous -> (N, C, H, W), same dtype: the gradient
    of ``up2x``'s input from the gradient of its output."""
    if _build.on_cuda(g, "up2x_adjoint"):
        return _adjoint_kernel(g)
    return up2x_adjoint_plain(g)


class _Up2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _up2x_kernel(x) if _build.on_cuda(x, "up2x") else up2x_plain(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return up2x_adjoint(g.contiguous())


def up2x(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) contiguous -> (N, C, 2H, 2W), same dtype; differentiable."""
    return _Up2x.apply(x)


up2x.launches = 0
up2x_adjoint.launches = 0
