"""The eval entry point: the port's cli/test.py against the JAX package's.

Both score the same Stanford-format dataset, written to tmp_path, with the
same weights: the JAX init of the CLI's model (full ResNet-34, six
transformer layers) at 64x128 / patch 32 with tamed heads, given to the JAX
CLI as an orbax checkpoint and to the port as a state dict
(state_dict_from_jax). The datasets' panorama size is set to 64x128 in both
packages (the real ones are 512x1024). Three panoramas at batch 2: the last
batch is short.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnifusion_tpu.data.datasets as jax_datasets
import omnifusion_torch.data.datasets as datasets
from omnifusion_tpu.cli import test as jax_test
from omnifusion_tpu.cli.common import add_common_args as jax_common_args
from omnifusion_tpu.cli.common import build_model as jax_build_model
from omnifusion_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from omnifusion_torch.cli import test as port_test
from omnifusion_torch.cli.common import add_common_args
from omnifusion_torch.models import state_dict_from_jax
from omnifusion_torch.utils import ply

from test_torch_port_data import write_split
from test_torch_port_model import _tame_heads

ERP = (64, 128)
FLAGS = ["--dataset", "stanford", "--erp_size", "64,128", "--patchsize", "32", "--batch", "2",
         "--visualize_interval", "1", "--save_ply"]
MODEL_FLAGS = {"oneshot": [], "iterative": ["--model", "iterative", "--iter", "2"]}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the suite runs in several worker processes at once
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def dataset(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    for cls in (datasets.StanfordDataset, jax_datasets.StanfordDataset):
        monkeypatch.setattr(cls, "pano_h", ERP[0])
        monkeypatch.setattr(cls, "pano_w", ERP[1])
    split = write_split(str(tmp_path), "stanford", 3, (128, 256))
    return ["--input_dir", str(tmp_path), "--testfile", split]


def _parse(add_args, argv):
    import argparse

    parser = argparse.ArgumentParser()
    add_args(parser, train=False)
    return parser.parse_args(argv)


@pytest.mark.parametrize("model", sorted(MODEL_FLAGS))
def test_eval_metrics_match_jax(tmp_path, dataset, model, capsys):
    argv = FLAGS + dataset + MODEL_FLAGS[model]
    jax_args = _parse(jax_common_args, argv + ["--mesh", "none"])
    jmodel, spec = jax_build_model(jax_args)
    v = _tame_heads(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, *ERP, 3))))
    for head in ("pred", "weight_pred"):  # full depth: 1e-3 keeps both heads live
        v["params"]["trunk"][head]["kernel"] *= 0.02
    JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(
        types.SimpleNamespace(step=0, opt_state={}, **v), "best")
    torch.save(state_dict_from_jax(v), tmp_path / "port.pt")

    jax_args = _parse(jax_common_args, argv + [
        "--mesh", "none", "--checkpoint", str(tmp_path / "jax_ckpt" / "best"),
        "--save_path", str(tmp_path / "jax_out")])
    theirs = jax_test.run_eval(jax_args)
    jax_lines = capsys.readouterr().out.splitlines()[-7:]
    args = _parse(add_common_args, argv + [
        "--device", "cpu", "--checkpoint", str(tmp_path / "port.pt"),
        "--save_path", str(tmp_path / "port_out")])
    ours = port_test.run_eval(args)
    lines = capsys.readouterr().out.splitlines()

    assert set(ours) == set(theirs) == {"abs_rel", "sq_rel", "lin_rms_sq", "log_rms_sq",
                                        "d1", "d2", "d3"}
    for k, t in theirs.items():
        assert abs(ours[k] - t) <= 1e-5 * max(abs(t), 1.0), (k, ours[k], t)
    assert 0.0 < theirs["d3"] and theirs["abs_rel"] < 1.0  # a live model scored
    # the seven lines in the JAX format
    assert [line.split(":")[0] for line in lines[-7:]] == [line.split(":")[0] for line in jax_lines]
    assert lines[-7].startswith("Avg. Abs. Rel. Error      : ")
    # the dumps of both batches: PNGs and a point cloud of the predicted depth
    for b in ("0000", "0001"):
        for suffix in ("_rgb.png", "_pred.png", "_gt.png", "_error.png", "_pred.ply"):
            assert (tmp_path / "port_out" / (b + suffix)).exists(), b + suffix
        got = ply.read_ply(str(tmp_path / "port_out" / f"{b}_pred.ply"))
        want = ply.read_ply(str(tmp_path / "jax_out" / f"{b}_pred.ply"))
        for c in ("red", "green", "blue"):
            np.testing.assert_array_equal(got[c], want[c])
        xyz = [np.stack([p[c] for c in "xyz"], -1) for p in (got, want)]
        np.testing.assert_allclose(xyz[0], xyz[1], rtol=1e-4, atol=1e-4)


def test_eval_without_cv2_still_writes_the_ply(tmp_path, dataset, monkeypatch, capsys):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *a, **k)

    # the samples are read with cv2 before the hook hides it from the dumps
    ds = datasets.StanfordDataset(dataset[1], dataset[3])
    samples = [ds[i] for i in range(len(ds))]
    monkeypatch.setattr(port_test, "build_dataset", lambda args, split, train: samples)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    args = _parse(add_common_args, FLAGS + dataset + [
        "--device", "cpu", "--seed", "0", "--save_path", str(tmp_path / "out")])
    port_test.run_eval(args)
    out = capsys.readouterr().out
    assert out.count("cv2 is not importable") == 1
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "0000_pred.ply", "0001_pred.ply", "run_config.json"]
