"""The fused depth and confidence heads: one 3x3 convolution of the decoder's
32-channel map with both heads' kernels, the bias, a ReLU on the prediction
(or none: segmentation logits) and a sigmoid on the confidence.

The JAX package leaves the heads to XLA's convolution
(``omnifusion_tpu/models/spherical_fusion.py:174-175``); no Pallas kernel
computes them. On the card cuDNN ran them as a transpose of the map, a
2-output implicit GEMM and three elementwise passes, at about a tenth of
the bytes' bound, so the serving path has a kernel of its own.

- ``fused_heads``: on a CUDA tensor it launches
  ``omnifusion_torch/csrc/heads.cu`` on the map in channels-last memory
  order (the decoder's map where autograd records nothing is so already;
  any other layout is copied once) and adds one to ``fused_heads.launches``
  and to the counter ``fused_heads.launches`` (``utils/profiling.count``).
  On a CPU tensor it runs ``fused_heads_plain``; on any other device it
  raises. It records nothing for autograd: the models call it only where
  autograd records nothing.
- ``fused_heads_plain``: the heads as the models compute them where
  gradients are recorded (``F.conv2d`` with both heads' parameters cast to
  the map's dtype, then the activations).

Bound on the card: bytes (the map read once, both outputs written once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from omnifusion_torch.ops import _build
from omnifusion_torch.utils.profiling import count

CHANNELS = 32  # the decoder's last width, which the kernel is built for
OUTPUTS = (2, 14)  # pred_channels + 1: depth, and 13-class segmentation
_DTYPES = (torch.float32, torch.bfloat16)


def fused_heads_plain(x, pred_weight, pred_bias, conf_weight, conf_bias,
                      activation: str = "relu"):
    """(pred, conf) of the map ``x`` (R, 32, H, W): the 3x3 convolution (zero
    padding 1) with both heads' parameters cast to ``x``'s dtype,
    ``activation`` ("relu" or "none") on pred, a sigmoid on conf."""
    y = F.conv2d(
        x,
        torch.cat([pred_weight, conf_weight]).to(x.dtype),
        torch.cat([pred_bias, conf_bias]).to(x.dtype),
        padding=1,
    )
    k = pred_weight.shape[0]
    pred = F.relu(y[:, :k]) if activation == "relu" else y[:, :k]
    return pred, torch.sigmoid(y[:, k:])


def _heads_kernel(x, pred_weight, pred_bias, conf_weight, conf_bias, activation: str = "relu"):
    """Launch csrc/heads.cu."""
    n_out = pred_weight.shape[0] + 1
    if n_out not in OUTPUTS:
        raise ValueError(f"fused_heads: {n_out} outputs; the kernel is built for {OUTPUTS}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_heads: unsupported dtype {x.dtype}")
    if x.dim() != 4 or x.shape[1] != CHANNELS:
        raise ValueError(f"fused_heads: the kernel is built for a width of {CHANNELS} channels: "
                         f"need an (R, {CHANNELS}, H, W) map, got {tuple(x.shape)}")
    for p, shape in ((pred_weight, (n_out - 1, CHANNELS, 3, 3)), (pred_bias, (n_out - 1,)),
                     (conf_weight, (1, CHANNELS, 3, 3)), (conf_bias, (1,))):
        if (p.dtype != torch.float32 or tuple(p.shape) != shape or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"fused_heads: need contiguous f32 parameters of shape {shape} on "
                             f"{x.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if activation not in ("relu", "none"):
        raise ValueError(f"fused_heads: activation must be 'relu' or 'none', got {activation!r}")
    x = x.contiguous(memory_format=torch.channels_last)
    r, _, h, w = x.shape
    pred = torch.empty(r, n_out - 1, h, w, dtype=x.dtype, device=x.device)
    conf = torch.empty(r, 1, h, w, dtype=x.dtype, device=x.device)
    err = _build.library().omnifusion_fused_heads(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype],
        pred_weight.data_ptr(), pred_bias.data_ptr(), conf_weight.data_ptr(), conf_bias.data_ptr(),
        pred.data_ptr(), conf.data_ptr(), n_out, r, h, w, int(activation == "relu"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "fused_heads")
    fused_heads.launches += 1
    count("fused_heads.launches")
    return pred, conf


def fused_heads(x, pred_weight, pred_bias, conf_weight, conf_bias, activation: str = "relu"):
    """(pred (R, k, H, W), conf (R, 1, H, W)) in ``x``'s dtype of the NCHW
    map ``x`` (R, 32, H, W) and the heads' f32 parameters: pred_weight (k,
    32, 3, 3), pred_bias (k,), conf_weight (1, 32, 3, 3), conf_bias (1,).
    On the card ``x`` is f32 or bf16 in any layout, k + 1 is in
    ``OUTPUTS``, and both outputs are contiguous whatever ``x``'s layout."""
    if _build.on_cuda(x, "fused_heads"):
        return _heads_kernel(x, pred_weight, pred_bias, conf_weight, conf_bias, activation)
    return fused_heads_plain(x, pred_weight, pred_bias, conf_weight, conf_bias, activation)


fused_heads.launches = 0
