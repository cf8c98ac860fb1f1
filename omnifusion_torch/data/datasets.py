"""Panorama depth and semantic datasets (host-side numpy, channel-last).

The port's copy of ``omnifusion_tpu/data/datasets.py``. Behavioral parity
with the reference loaders:

  - StanfordDataset:   dataset_loader_stanford.py (1024x512, depth 16-bit
    PNG / 65535 * 128, max depth 8.0, optional channel-permute aug)
  - MatterportDataset: dataset_loader_matterport.py (1024x512, depth 16-bit
    PNG / 4000, max depth 10.0)
  - ThreeSixtyDDataset: dataset_loader_360d.py (512x256, depth EXR channel R,
    max depth 8.0, optional gamma aug)
  - SemanticDataset: RGB + uint8 label PNGs (the reference's segmentation
    dataset module is absent from its repo; this is the JAX package's
    working equivalent); SyntheticSemanticDataset for smoke runs

Shared behavior (each reference loader duplicates it): split files are
whitespace-separated relative paths (rgb depth [semantic]) loaded via
np.loadtxt; RGB read+resized with cv2 INTER_AREA and scaled to [0,1], in
cv2's BGR order, kept end to end; augmentations = random horizontal flip +
horizontal roll quantized to quarter-width, drawn from one numpy generator
per dataset in the JAX package's order, so a seed gives the same samples;
mask = (depth <= max) & (depth > min); depth zeroed outside the mask. A
depth sample is rgb (H, W, 3) f32, depth and mask (H, W, 1) f32; a semantic
sample is rgb (H, W, 3) f32 and labels (H, W) int32, -1 where ignored.

cv2 is imported inside the readers only: the module imports without it.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np


def _read_rgb(path: str, size_wh: tuple[int, int]) -> np.ndarray:
    import cv2

    rgb = cv2.imread(path)
    if rgb is None:
        raise FileNotFoundError(f"cannot read RGB image {path!r}")
    return cv2.resize(rgb, size_wh, interpolation=cv2.INTER_AREA)


def _read_depth_png(path: str, size_wh: tuple[int, int], scale: float) -> np.ndarray:
    import cv2

    depth = cv2.imread(path, -1)
    if depth is None:
        raise FileNotFoundError(f"cannot read depth image {path!r}")
    depth = depth.astype(np.float32)
    depth = cv2.resize(depth, size_wh, interpolation=cv2.INTER_AREA)
    return depth * scale


def read_exr_r(path: str) -> np.ndarray:
    """Read channel R of an EXR file (the 360D depth format,
    dataset_loader_360d.py:109-121).

    Tries the native C++ reader (omnifusion_torch/native/exr_reader.cpp),
    then cv2 where it is built with OpenEXR (for compressions the native
    reader refuses, such as PIZ). The JAX package's last fallback, the
    OpenEXR module, is left out. If neither decodes the file, the error
    names the native reader's failure and chains it."""
    try:
        from omnifusion_torch.native import read_exr_channel

        return read_exr_channel(path, "R")
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        native_error = e  # no g++ or zlib to build it, or a file it cannot decode
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
    except ImportError:
        cv2_failure = "cv2 is not importable"
    else:
        try:
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        except cv2.error:
            img = None
        if img is not None:
            return (img[..., 0] if img.ndim == 3 else img).astype(np.float32)
        cv2_failure = "cv2 could not decode it (built without OpenEXR?)"
    raise RuntimeError(
        f"no EXR reader could read {path!r}: the native reader failed "
        f"({type(native_error).__name__}: {native_error}) and {cv2_failure}"
    ) from native_error


class PanoDepthDataset:
    """Base dataset: split-list parsing, augmentation, masking."""

    pano_w: int = 1024
    pano_h: int = 512
    max_depth: float = 8.0
    min_depth: float = 0.1

    def __init__(
        self,
        root_path: str,
        path_to_img_list: str,
        rotate: bool = False,
        flip: bool = False,
        permute_color: bool = False,
        gamma: bool = False,
        seed: Optional[int] = None,
    ):
        self.root_path = root_path
        self.image_list = np.loadtxt(path_to_img_list, dtype=str)
        if self.image_list.ndim == 1:  # a one-line split file
            self.image_list = self.image_list[None, :]
        self.rotate = rotate
        self.flip = flip
        self.permute_color = permute_color
        self.gamma = gamma
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.image_list)

    # subclass hooks -------------------------------------------------------
    def read_rgb(self, path: str) -> np.ndarray:
        return _read_rgb(path, (self.pano_w, self.pano_h))

    def read_depth(self, path: str) -> np.ndarray:
        raise NotImplementedError

    # ----------------------------------------------------------------------
    def flip_and_roll(self, rgb: np.ndarray, target: np.ndarray):
        """The random horizontal flip, then the horizontal roll quantized to
        quarter-width (dataset_loader_stanford.py:63-67), of the panorama
        and its per-pixel target alike, drawn in this order."""
        if self.flip and self.rng.integers(2) == 0:
            rgb = np.flip(rgb, axis=1)
            target = np.flip(target, axis=1)
        if self.rotate:
            q = rgb.shape[1] // 4
            dx = int(self.rng.integers(rgb.shape[1])) // q * q
            rgb = np.roll(rgb, dx, axis=1)
            target = np.roll(target, dx, axis=1)
        return rgb, target

    def __getitem__(self, idx: int):
        paths = self.image_list[idx]
        rgb = self.read_rgb(self.root_path + paths[0]).astype(np.float32) / 255.0
        rgb, depth = self.flip_and_roll(rgb, self.read_depth(self.root_path + paths[1]))

        if self.permute_color and self.rng.integers(4) == 0:
            rgb = rgb[:, :, self.rng.permutation(3)]

        if self.gamma:
            p = float(self.rng.uniform(1.0, 2.0))
            if self.rng.integers(2) == 0:
                p = 1.0 / p
            rgb = rgb**p

        depth = depth[..., None]
        mask = ((depth <= self.max_depth) & (depth > self.min_depth)).astype(np.float32)
        depth = depth * mask
        return (
            np.ascontiguousarray(rgb, dtype=np.float32),
            np.ascontiguousarray(depth, dtype=np.float32),
            mask,
        )


class StanfordDataset(PanoDepthDataset):
    """Stanford2D3D: depth = 16-bit PNG / 65535 * 128, max 8 m."""

    def read_depth(self, path: str) -> np.ndarray:
        return _read_depth_png(path, (self.pano_w, self.pano_h), 128.0 / 65535.0)


class MatterportDataset(PanoDepthDataset):
    """Matterport3D: depth = 16-bit PNG / 4000, max 10 m."""

    max_depth = 10.0

    def read_depth(self, path: str) -> np.ndarray:
        return _read_depth_png(path, (self.pano_w, self.pano_h), 1.0 / 4000.0)


class ThreeSixtyDDataset(PanoDepthDataset):
    """360D (OmniDepth): 512x256 panos, depth from EXR channel R."""

    pano_w = 512
    pano_h = 256

    def read_depth(self, path: str) -> np.ndarray:
        return read_exr_r(path)


class SemanticDataset(PanoDepthDataset):
    """RGB + semantic labels from split lists of 3 columns (rgb depth
    semantic) or 2 (rgb semantic).

    Label maps are PNGs of uint8 class ids (a 3-channel PNG keeps its
    channel 0), resized with INTER_NEAREST; 255 decodes to the ignore index
    -1 (cross-entropy ignore, train_erp_sem.py:203). Augmented as the depth
    datasets are (``flip_and_roll``)."""

    def __getitem__(self, idx: int):
        import cv2

        paths = self.image_list[idx]
        rgb = self.read_rgb(self.root_path + paths[0]).astype(np.float32) / 255.0
        sem_path = self.root_path + (paths[2] if len(paths) > 2 else paths[1])
        sem = cv2.imread(sem_path, -1)
        if sem is None:
            raise FileNotFoundError(f"cannot read label map {sem_path!r}")
        if sem.ndim == 3:
            sem = sem[..., 0]
        sem = cv2.resize(
            sem.astype(np.int32), (self.pano_w, self.pano_h), interpolation=cv2.INTER_NEAREST
        )
        rgb, labels = self.flip_and_roll(rgb, np.where(sem == 255, -1, sem).astype(np.int32))
        return np.ascontiguousarray(rgb, dtype=np.float32), np.ascontiguousarray(labels)


class SyntheticSemanticDataset:
    """Procedural panorama/label pairs for segmentation smoke runs: a
    quarter-size checkerboard of class ids, colored by class, with noise."""

    def __init__(self, size=16, pano_h=128, pano_w=256, num_classes=13, seed=0):
        self.size, self.pano_h, self.pano_w = size, pano_h, pano_w
        self.num_classes, self.seed = num_classes, seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 9176 + idx)
        h, w, c = self.pano_h, self.pano_w, self.num_classes
        yy, xx = np.mgrid[0:h, 0:w]
        labels = ((xx // (w // 4) + yy // (h // 4)) % c).astype(np.int32)
        rgb = np.stack(
            [labels / c, ((labels * 37) % c) / c, ((labels * 11) % c) / c], -1
        ).astype(np.float32)
        rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
        return np.clip(rgb, 0, 1), labels


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


_DATASETS = {
    "stanford": StanfordDataset,
    "matterport": MatterportDataset,
    "360d": ThreeSixtyDDataset,
    "synthetic": SyntheticDataset,
}


def make_dataset(name: str, *args, **kwargs):
    try:
        cls = _DATASETS[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(_DATASETS)}")
    return cls(*args, **kwargs)
