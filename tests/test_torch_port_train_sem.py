"""The segmentation train entry point on the CPU: one epoch of
``python -m omnifusion_torch.cli.train_sem --dataset synthetic`` at 64x128,
its history, its checkpoints, and no kernel launched (on CPU tensors every
wrapper runs its plain version)."""

import numpy as np
import pytest
import torch

from omnifusion_torch.cli import train_sem
from omnifusion_torch.models import SphericalFusionSeg
from omnifusion_torch.ops.probe import probe
from omnifusion_torch.ops.quad_blend import quad_blend, quad_spread
from omnifusion_torch.ops.upsample import up2x, up2x_adjoint


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _launches():
    return [f.launches for f in (quad_blend, quad_spread, up2x, up2x_adjoint, probe)]


def test_train_sem_cli_on_cpu(tmp_path):
    # the fixed synthetic sets: 32 panoramas to train (2 steps at batch 16),
    # 8 to validate
    argv = ["--dataset", "synthetic", "--device", "cpu", "--erp_size", "64,128",
            "--patchsize", "32", "--batch", "16", "--workers", "2", "--epochs", "1",
            "--num_classes", "5", "--seed", "0", "--save_path", str(tmp_path / "run")]
    before = _launches()
    history = train_sem.main(argv)
    assert _launches() == before
    assert set(history) == {"train_loss", "miou", "best_miou"}
    assert len(history["train_loss"]) == len(history["miou"]) == 1
    assert np.isfinite(history["train_loss"]).all()
    miou = history["miou"][0]
    assert 0.0 <= miou <= 1.0 and history["best_miou"] == max(miou, 0.0)
    ckpt = tmp_path / "run" / "ckpt"
    assert (ckpt / "latest.pt").exists() and (ckpt / "best.pt").exists() == (miou > 0)
    saved = torch.load(ckpt / "latest.pt", weights_only=True)
    assert saved["step"] == 2 and saved["model"]["pred.weight"].shape == (5, 32, 3, 3)
    assert (tmp_path / "run" / "run_config.json").exists()


def test_train_sem_parser_keeps_the_dataset_choices():
    # the JAX entry point's docstring names --dataset semantic, which its
    # parser refuses: any real dataset name reads SemanticDataset
    parser = train_sem.build_parser()
    assert parser.parse_args([]).num_classes == 13
    with pytest.raises(SystemExit):
        parser.parse_args(["--dataset", "semantic"])


def test_predict_is_eval_mode_argmax():
    from omnifusion_torch.models import init_weights
    from omnifusion_torch.projection import ProjectionSpec

    model = init_weights(SphericalFusionSeg(ProjectionSpec.create((64, 128), 32, (80, 80), 4),
                                            num_classes=4, depth=1, device="cpu"), 0)
    rgb = torch.from_numpy(np.random.default_rng(0).random((1, 64, 128, 3), dtype=np.float32))
    model.train()
    labels = train_sem.predict(model, rgb)
    assert not model.training and labels.shape == (1, 64, 128)
    with torch.no_grad():
        assert torch.equal(labels, model(rgb).argmax(-1))
