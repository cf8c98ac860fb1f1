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
