"""The port's serving entry point and its device rule, on the CPU."""

import numpy as np
import pytest
import torch

from omnifusion_torch.cli import infer
from omnifusion_torch.models import SphericalFusion
from omnifusion_torch.projection import ProjectionSpec

ERP = (64, 128)
FLAGS = ["--erp_size", "64,128", "--patchsize", "32", "--fov", "80", "--nrows", "4"]


def _panoramas(tmp_path, n):
    rng = np.random.default_rng(0)
    d = tmp_path / "panos"
    d.mkdir()
    frames = [rng.random((*ERP, 3), dtype=np.float32) for _ in range(n)]
    for i, f in enumerate(frames):
        np.save(d / f"pano{i}.npy", f)
    return d, frames


def test_infer_writes_the_models_depth(tmp_path):
    inputs, frames = _panoramas(tmp_path, 3)  # batches of 2 and 1
    out = tmp_path / "out"
    argv = ["--input", str(inputs), "--save_path", str(out), "--batch", "2", "--device", "cpu",
            "--seed", "7", *FLAGS]
    written = infer.run_infer(infer.build_parser().parse_args(argv))
    assert [p.rsplit("/", 1)[1] for p in written] == [f"pano{i}_depth.npy" for i in range(3)]

    model = infer.build_model(infer.build_parser().parse_args(argv))
    with torch.no_grad():
        want = model(torch.from_numpy(np.stack(frames)))[..., 0].numpy()
    for path, w in zip(written, want):
        got = np.load(path)
        assert got.shape == ERP and got.dtype == np.float32
        assert np.isfinite(got).all() and (got >= 0).all()
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)

    # a saved state dict answers the same
    ckpt = tmp_path / "model.pt"
    torch.save(model.state_dict(), ckpt)
    out2 = tmp_path / "out2"
    argv2 = ["--input", str(inputs / "pano1.npy"), "--save_path", str(out2), "--checkpoint",
             str(ckpt), "--device", "cpu", *FLAGS]
    (again,) = infer.run_infer(infer.build_parser().parse_args(argv2))
    np.testing.assert_allclose(np.load(again), want[1], rtol=1e-5, atol=1e-6)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    # with no device given, the port runs on the card or raises; it never
    # falls back to the CPU by itself
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ProjectionSpec.create(ERP, 32, (80, 80), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SphericalFusion(spec)
    inputs, _ = _panoramas(tmp_path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--input", str(inputs), "--save_path", str(tmp_path / "o"), *FLAGS])


def test_infer_reads_images_and_writes_png_and_ply(tmp_path):
    # an image goes through the datasets' RGB reader (cv2's BGR order,
    # INTER_AREA resize, [0, 1]) and answers as its .npy array does
    cv2 = pytest.importorskip("cv2")
    from omnifusion_torch.data.datasets import _read_rgb
    from omnifusion_torch.utils import ply

    inputs = tmp_path / "imgs"
    inputs.mkdir()
    bgr = (np.random.default_rng(2).random((128, 256, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(inputs / "room.png"), bgr)
    frame = _read_rgb(str(inputs / "room.png"), (ERP[1], ERP[0])).astype(np.float32) / 255.0
    np.save(tmp_path / "room.npy", frame)
    common = ["--device", "cpu", "--seed", "3", *FLAGS]
    (from_png,) = infer.run_infer(infer.build_parser().parse_args(
        ["--input", str(inputs), "--save_path", str(tmp_path / "a"), "--save_ply", *common]))
    (from_npy,) = infer.run_infer(infer.build_parser().parse_args(
        ["--input", str(tmp_path / "room.npy"), "--save_path", str(tmp_path / "b"), *common]))
    depth = np.load(from_png)
    np.testing.assert_array_equal(depth, np.load(from_npy))
    png = cv2.imread(str(tmp_path / "a" / "room_depth.png"))
    assert png.shape == (*ERP, 3) and png.dtype == np.uint8
    cloud = ply.read_ply(str(tmp_path / "a" / "room.ply"))
    assert len(cloud) == ERP[0] * ERP[1]
    np.testing.assert_allclose(np.linalg.norm(np.stack([cloud[c] for c in "xyz"], -1), axis=-1),
                               depth.reshape(-1), rtol=1e-5, atol=1e-6)
    # colours flipped to RGB for the red/green/blue labels
    np.testing.assert_array_equal(cloud["red"], (frame[..., 2].reshape(-1) * 255).astype(np.uint8))
    assert not (tmp_path / "b" / "room.ply").exists()
