"""The epilogue of a convolution whose eval-mode BatchNorm is folded into it,
in place on the convolution's output ``y``: ``relu(y * scale + bias)``, or
with a residual ``relu(T(y * scale + bias) + r)``, ``r`` the residual ``z``
or a shortcut convolution's output through its BatchNorm, ``T(z * z_scale +
z_bias)``; ``scale``, ``bias`` (and ``z_scale``, ``z_bias``) the BatchNorms'
f32 affine maps per channel, T() a rounding to ``y``'s dtype. The
roundings are the bf16 recipe's: a BatchNorm's output and the residual sum
are bf16 activations, as in the unfolded trunk (csrc/epilogue.cu says why).

The JAX package has no counterpart: XLA fuses its BatchNorm, residual add
and ReLU into the convolution's consumers. On the card the unfolded trunk
ran them as three passes over each convolution's output (cuDNN's
BatchNorm, an add, a ReLU); ``models/layers.py: conv_bn_relu`` runs this
one pass instead.

- ``conv_epilogue``: on a CUDA tensor it launches
  ``omnifusion_torch/csrc/epilogue.cu`` (16-byte vectors where they fit,
  one element a thread elsewhere) and adds one to ``conv_epilogue.launches``
  and to the counter ``conv_epilogue.launches``
  (``utils/profiling.count``); it raises for what the kernel does not take:
  a dtype other than f32 and bf16, a ``y`` in neither contiguous NCHW nor
  channels-last memory order, a ``z`` of another dtype, shape or memory
  order, per-channel operands that are not contiguous f32 of ``y``'s
  channels on its device, a ``z_scale`` without its ``z_bias`` or ``z``. On the CPU it runs ``conv_epilogue_plain``. It
  records nothing for autograd: ``conv_bn_relu`` calls it only where
  autograd records nothing.
- ``conv_epilogue_plain``: the same sums in f32 (f64 for f64 operands), in
  the kernel's order, with its roundings to ``y``'s dtype.

Bound on the card: bytes (``y`` read and written once, ``z`` read once).
"""

from __future__ import annotations

from typing import Optional

import torch

from omnifusion_torch.ops import _build
from omnifusion_torch.utils.profiling import count

_DTYPES = (torch.float32, torch.bfloat16)


def _channel(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).reshape(1, -1, 1, 1)


def conv_epilogue_plain(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        z: Optional[torch.Tensor] = None, z_scale: Optional[torch.Tensor] = None,
                        z_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y`` (N, C, H, W) overwritten with relu(y scale + bias), or
    relu(T(y scale + bias) + r), r = z or T(z z_scale + z_bias), per channel,
    in f32 (f64 for an f64 ``y``), T() a rounding to ``y``'s dtype; returns
    ``y``."""
    cdt = torch.promote_types(y.dtype, torch.float32)

    def rounded(t):
        return t.to(y.dtype).to(cdt)

    a = y.to(cdt) * _channel(scale, cdt) + _channel(bias, cdt)
    if z is not None:
        r = z.to(cdt)
        if z_scale is not None:
            r = rounded(r * _channel(z_scale, cdt) + _channel(z_bias, cdt))
        a = rounded(a) + r
    return y.copy_(a.clamp_min_(0))


def memory_order(y: torch.Tensor) -> Optional[torch.memory_format]:
    """The kernel's form for ``y``: ``torch.channels_last`` (NHWC in memory;
    also where both orders coincide, as in a 1x1 map), ``torch.contiguous_format``
    (NCHW), or None: neither."""
    if y.dim() == 4 and y.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    if y.dim() == 4 and y.is_contiguous():
        return torch.contiguous_format
    return None


def _check(y, scale, bias, z, z_scale, z_bias) -> torch.memory_format:
    """``y``'s form (``memory_order``), or the reason the kernel does not
    take these operands, raised."""
    if y.dtype not in _DTYPES:
        raise TypeError(f"conv_epilogue: dtype {y.dtype}; the kernel is built for "
                        f"{_DTYPES}")
    fmt = memory_order(y)
    if fmt is None:
        raise ValueError(f"conv_epilogue: y {tuple(y.shape)} with strides {y.stride()} is in "
                         "neither NCHW nor channels-last memory order")
    if z is not None and (z.dtype != y.dtype or z.shape != y.shape or z.device != y.device
                          or not z.is_contiguous(memory_format=fmt)):
        raise ValueError(f"conv_epilogue: z {z.dtype} {tuple(z.shape)} with strides "
                         f"{z.stride()} is not y's dtype, shape and memory order ({y.dtype} "
                         f"{tuple(y.shape)}, {fmt})")
    if (z_scale is None) != (z_bias is None) or (z_scale is not None and z is None):
        raise ValueError("conv_epilogue: z_scale and z_bias come together, with a z")
    for name, t in (("scale", scale), ("bias", bias), ("z_scale", z_scale), ("z_bias", z_bias)):
        if t is not None and not (t.dtype == torch.float32 and t.is_contiguous()
                                  and t.numel() == y.shape[1] and t.device == y.device):
            raise ValueError(f"conv_epilogue: {name} must be {y.shape[1]} contiguous f32 "
                             f"values on {y.device}")
    return fmt


def _epilogue_kernel(y, scale, bias, z=None, z_scale=None, z_bias=None) -> torch.Tensor:
    """Launch csrc/epilogue.cu on operands that ``_check`` accepts."""
    n, c, h, w = y.shape
    nhwc = memory_order(y) == torch.channels_last
    err = _build.library().omnifusion_conv_epilogue(
        y.data_ptr(), None if z is None else z.data_ptr(), _build.DTYPE_CODES[y.dtype],
        scale.data_ptr(), bias.data_ptr(), None if z_scale is None else z_scale.data_ptr(),
        None if z_bias is None else z_bias.data_ptr(), y.numel(), c, h * w, int(nhwc),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(err, "conv_epilogue")
    conv_epilogue.launches += 1
    count("conv_epilogue.launches")
    return y


def conv_epilogue(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  z: Optional[torch.Tensor] = None, z_scale: Optional[torch.Tensor] = None,
                  z_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y`` (N, C, H, W) overwritten with its epilogue (the module's
    docstring); ``scale``, ``bias``, ``z_scale``, ``z_bias`` (C,) f32 on
    ``y``'s device; ``z`` ``y``'s shape. Returns ``y``."""
    if _build.on_cuda(y, "conv_epilogue"):
        _check(y, scale, bias, z, z_scale, z_bias)
        return _epilogue_kernel(y, scale, bias, z, z_scale, z_bias)
    return conv_epilogue_plain(y, scale, bias, z, z_scale, z_bias)


conv_epilogue.launches = 0
