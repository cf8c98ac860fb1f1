"""Panorama depth datasets (host-side numpy, channel-last).

The port's copy of ``omnifusion_tpu/data/datasets.py:SyntheticDataset``; the
real datasets (Stanford2D3D, Matterport3D, 360D) read files that are not in
the repository and are not ported yet. A sample is rgb (H, W, 3) f32 in
[0, 1], depth and mask (H, W, 1) f32.
"""

from __future__ import annotations

import numpy as np


class SyntheticDataset:
    """Procedural panorama/depth pairs for smoke tests and benchmarks."""

    def __init__(self, size: int = 16, pano_h: int = 128, pano_w: int = 256, seed: int = 0):
        self.size = size
        self.pano_h = pano_h
        self.pano_w = pano_w
        self.seed = seed
        self.max_depth = 8.0
        self.min_depth = 0.1

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.pano_h, self.pano_w
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        rgb = np.stack(
            [
                0.5 + 0.5 * np.sin(xx / w * 2 * np.pi + rng.uniform(0, 6)),
                ((xx // 16 + yy // 16) % 2),
                yy / h,
            ],
            axis=-1,
        ).astype(np.float32)
        depth = (2.0 + 3.0 * rgb[..., :1] + rng.uniform(0, 1)).astype(np.float32)
        mask = ((depth <= self.max_depth) & (depth > self.min_depth)).astype(np.float32)
        return rgb, depth * mask, mask
