"""The traffic generator: every input of a run, made from ``--seed``.

One general generator reads a traffic mix's parameters (a JSON file under
``benchmark/traffic/``) and the cell's configuration. The inputs are made
on the device by a ``torch.Generator`` seeded from the run's seed, in a
few large calls; the same seed gives the same inputs, and every seed the
same sizes and the same schedule.

- ``erp_pool``: ``pool`` distinct batches of ``batch`` panoramas,
  (B, H, W, 3) f32 in [0, 1).
- ``train_pool``: ``pool`` distinct batches of a panorama, its depth in
  ``depth_range`` metres (a smooth field: seeded noise at 1/32 of the
  panorama, upsampled bilinearly) and its mask (``mask_share`` of the
  pixels valid, drawn per pixel).
- ``sampled``: the indices of the window's answers that the check
  compares, drawn from the seed among the first ``check_among``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS, INPUTS, SAMPLE = 0, 1, 2


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the run's streams (weights, inputs, the
    check's sample), from a seed of any size."""
    return int(np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)[0]) >> 1


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, INPUTS))
    return g


def erp_pool(cfg, traffic, seed: int, device) -> list[torch.Tensor]:
    h, w = cfg["erp_size"]
    n, b = traffic["pool"], traffic["batch"]
    x = torch.rand(n, b, h, w, 3, generator=_gen(seed, device), device=device)
    return list(x.unbind(0))


def train_pool(cfg, traffic, seed: int, device) -> list[dict]:
    h, w = cfg["erp_size"]
    n, b = traffic["pool"], traffic["batch"]
    g = _gen(seed, device)
    lo, hi = traffic["depth_range"]
    rgb = torch.rand(n * b, h, w, 3, generator=g, device=device)
    coarse = torch.rand(n * b, 1, h // 32, w // 32, generator=g, device=device)
    depth = lo + (hi - lo) * F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    mask = (torch.rand(n * b, 1, h, w, generator=g, device=device) < traffic["mask_share"]).float()
    depth, mask = depth.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)
    return [{"rgb": rgb[i * b:(i + 1) * b], "depth": depth[i * b:(i + 1) * b].contiguous(),
             "mask": mask[i * b:(i + 1) * b].contiguous()} for i in range(n)]


def sampled(traffic, seed: int) -> list[int]:
    rng = np.random.default_rng(stream_seed(seed, SAMPLE))
    return sorted(int(i) for i in rng.choice(traffic["check_among"], traffic["check_count"],
                                             replace=False))
