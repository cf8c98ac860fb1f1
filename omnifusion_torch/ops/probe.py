"""The toolchain probe: ``2 * x`` on float32.

Replaces the Pallas probe of ``tools/bench_pallas_merge.py:57-63``, which the
merge shootout launches first to fail fast when the toolchain cannot build
or launch a kernel; ``omnifusion_torch/tools/bench_merge.py`` launches this
one first for the same reason, and ``chip_smoke.py`` holds it bit for bit
against ``probe_plain``.

- ``probe``: on a CUDA tensor it launches ``omnifusion_torch/csrc/probe.cu``
  and adds one to ``probe.launches``; on a CPU tensor it runs
  ``probe_plain``; on any other device it raises.
- ``probe_plain``: ``x * 2.0`` in plain PyTorch.

Bound on the card: bytes (input + output over 3.35 TB/s); at the shootout's
(256, 128) the launch sets the time.
"""

from __future__ import annotations

import torch

from omnifusion_torch.ops import _build


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def _probe_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/probe.cu."""
    if x.dtype != torch.float32:
        raise TypeError(f"probe: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"probe: need a contiguous tensor, got strides {x.stride()}")
    out = torch.empty_like(x)
    err = _build.library().omnifusion_probe(
        x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream
    )
    _build.check(err, "probe")
    probe.launches += 1
    return out


def probe(x: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 tensor -> ``2 * x``, same shape."""
    if _build.on_cuda(x, "probe"):
        return _probe_kernel(x)
    return probe_plain(x)


probe.launches = 0
