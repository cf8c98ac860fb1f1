"""The port's segmentation data and metric against the JAX package's: the
mIoU (utils/iou.py), SyntheticSemanticDataset, and SemanticDataset on label
PNGs written to tmp_path.

Both datasets read with cv2 (the RGB with INTER_AREA, the labels with
INTER_NEAREST) and draw the flip, then the quarter-width roll, from one
numpy generator per dataset in the same order, so the same seed and split
file give the same samples, bit for bit.
"""

import numpy as np
import pytest

import omnifusion_tpu.data.datasets as jax_datasets
import omnifusion_tpu.utils.iou as jax_iou
import omnifusion_torch.data.datasets as datasets
from omnifusion_torch.data import DataLoader
from omnifusion_torch.utils import NUM_CLASSES, confusion_matrix, evaluate_iou, per_class_iou

cv2 = pytest.importorskip("cv2")

H, W = 64, 128


def test_iou_matches_jax():
    rng = np.random.default_rng(0)
    nc = 6
    preds = [rng.integers(0, nc, (H, W)) for _ in range(3)]
    gts = [rng.integers(-1, nc, (H, W)) for _ in range(3)]  # -1: ignored
    for p, g in zip(preds, gts):  # class 5 is absent from both: its IoU is NaN
        p[p == 5] = 0
        g[g == 5] = 1
    gts[0][0, :7] = 255  # out of range: ignored as well
    miou, ious = evaluate_iou(preds, gts, nc)
    jmiou, jious = jax_iou.evaluate_iou(preds, gts, nc)
    assert np.isnan(ious[5]) and np.isfinite(ious[:5]).all()
    np.testing.assert_array_equal(ious, jious)
    assert miou == jmiou == pytest.approx(np.mean(ious[:5]), rel=1e-12)
    cm = confusion_matrix(preds[0], gts[0], nc)
    np.testing.assert_array_equal(cm, jax_iou.confusion_matrix(preds[0], gts[0], nc))
    assert cm.sum() == ((gts[0] >= 0) & (gts[0] < nc)).sum()
    np.testing.assert_array_equal(per_class_iou(cm), jax_iou.per_class_iou(cm))
    assert NUM_CLASSES == jax_iou.NUM_CLASSES == 13


@pytest.mark.parametrize("seed,nc", [(0, 13), (5, 4)])
def test_synthetic_semantic_matches_jax(seed, nc):
    ours = datasets.SyntheticSemanticDataset(3, H, W, nc, seed)
    theirs = jax_datasets.SyntheticSemanticDataset(3, H, W, nc, seed)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        (rgb, lab), (jrgb, jlab) = ours[i], theirs[i]
        assert rgb.dtype == np.float32 and lab.dtype == np.int32 and lab.shape == (H, W)
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(lab, jlab)


def _write_split(tmp_path, rng, columns: int):
    """Four panoramas (2x the size the datasets read) with label PNGs: two
    of 1 channel, two of 3 (whose channel 0 holds the ids), with 255 in
    them; a split file of ``columns`` columns."""
    lines = []
    for i in range(4):
        rgb = (rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8)
        lab = rng.integers(0, 13, (2 * H, 2 * W)).astype(np.uint8)
        lab[rng.random(lab.shape) < 0.1] = 255
        if i % 2:
            lab = np.stack([lab, (lab + 7) % 13, np.full_like(lab, 9)], -1)
        cv2.imwrite(str(tmp_path / f"rgb{i}.png"), rgb)
        cv2.imwrite(str(tmp_path / f"sem{i}.png"), lab)
        cols = [f"rgb{i}.png", f"depth{i}.png", f"sem{i}.png"]
        lines.append(" ".join(cols if columns == 3 else cols[::2]))
    split = tmp_path / f"split{columns}.txt"
    split.write_text("\n".join(lines) + "\n")
    return str(split)


@pytest.mark.parametrize("columns", [3, 2])
@pytest.mark.parametrize("augment", [False, True])
def test_semantic_dataset_matches_jax(tmp_path, monkeypatch, columns, augment):
    for mod in (datasets, jax_datasets):
        monkeypatch.setattr(mod.SemanticDataset, "pano_h", H)
        monkeypatch.setattr(mod.SemanticDataset, "pano_w", W)
    split = _write_split(tmp_path, np.random.default_rng(columns), columns)
    root = str(tmp_path) + "/"
    kw = dict(rotate=augment, flip=augment, seed=7)
    ours = datasets.SemanticDataset(root, split, **kw)
    theirs = jax_datasets.SemanticDataset(root, split, **kw)
    moved = 0
    for _ in range(3):  # the generators advance in step
        for i in range(len(ours)):
            (rgb, lab), (jrgb, jlab) = ours[i], theirs[i]
            assert rgb.shape == (H, W, 3) and rgb.dtype == np.float32
            assert lab.shape == (H, W) and lab.dtype == np.int32
            assert lab.min() == -1 and lab.max() <= 12  # 255 decoded to -1
            np.testing.assert_array_equal(rgb, jrgb)
            np.testing.assert_array_equal(lab, jlab)
            plain = datasets.SemanticDataset(root, split)[i]
            moved += not np.array_equal(lab, plain[1])
    assert (moved > 0) == augment  # the flip and roll ran, or nothing moved
    # the loader's batches of (rgb, labels)
    batch = next(iter(DataLoader(ours, 2, num_workers=1)))
    assert set(batch) == {"rgb", "labels"} and batch["labels"].shape == (2, H, W)


def test_semantic_dataset_keeps_channel_zero(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets.SemanticDataset, "pano_h", H)
    monkeypatch.setattr(datasets.SemanticDataset, "pano_w", W)
    lab = np.zeros((H, W, 3), np.uint8)
    lab[..., 0], lab[..., 1], lab[..., 2] = 3, 8, 255
    lab[:, :5, 0] = 255
    cv2.imwrite(str(tmp_path / "rgb.png"), np.zeros((H, W, 3), np.uint8))
    cv2.imwrite(str(tmp_path / "sem.png"), lab)
    (tmp_path / "split.txt").write_text("rgb.png sem.png\n")
    _, labels = datasets.SemanticDataset(str(tmp_path) + "/", str(tmp_path / "split.txt"))[0]
    assert (labels[:, :5] == -1).all() and (labels[:, 5:] == 3).all()
