"""Training with --bf16: the port's bf16 train step against the JAX
package's, and the train entry point's new flags, on the CPU.

The bf16 step (trunk in bf16 on f32 parameters, BatchNorm statistics and
loss in f32, the merge's source in f16) is held to witnesses from the same
run, as tests/test_torch_port_bf16.py holds the bf16 forward: oneDNN's bf16
convolutions round at other places than XLA's, so each package's bf16 step
is measured against its own f32 step, and the port's distance may be at
most twice the JAX package's. Weights: the JAX init at 64x128 / patch 32
with one-block stages and a depth-1 transformer, tamed heads, as
tests/test_torch_port_train.py.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnifusion_tpu.data.datasets as jax_datasets
import omnifusion_torch.data.datasets as datasets
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.training.trainer import _forward_loss
from omnifusion_torch.cli import train as train_cli
from omnifusion_torch.models import SphericalFusion, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, train_step

from test_torch_port_data import write_split
from test_torch_port_train import ERP, ONE_BLOCK, PATCH, _batch, _jax_sd, _rel, _tame_heads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the suite runs in several worker processes at once
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _distance(loss, grads, loss_ref, grads_ref) -> dict:
    rels = [_rel(grads[n], grads_ref[n]) for n in grads_ref]
    return {"loss": abs(loss / loss_ref - 1), "grad_max": max(rels),
            "grad_median": float(np.median(rels))}


@pytest.fixture(scope="module")
def steps():
    """Loss and gradients of one train-mode step, f32 and bf16 (f16 merge),
    of each package from the same weights and batch."""
    batch = _batch(0)
    kw = dict(spec=JaxSpec.create(ERP, PATCH, (80, 80), 4), depth=1, encoder_stages=ONE_BLOCK)
    v = _tame_heads(jax.jit(JaxSphericalFusion(**kw).init)(
        jax.random.PRNGKey(3), jnp.asarray(batch["rgb"][:1])))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    out = {}
    for name, dt in (("f32", {}), ("bf16", dict(dtype=jnp.bfloat16, merge_dtype=jnp.float16))):
        model = JaxSphericalFusion(**kw, **dt, kernel_impl="pallas_full")
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: _forward_loss(model, p, v["batch_stats"], jb, True), has_aux=True
        ))(v["params"])
        sd = _jax_sd({"grads": jax.tree_util.tree_map(np.asarray, grads),
                      "new_stats": v["batch_stats"]}, "grads")
        port = SphericalFusion(ProjectionSpec.create(ERP, PATCH, (80, 80), 4), depth=1,
                               encoder_stages=ONE_BLOCK, device="cpu",
                               dtype=torch.bfloat16 if dt else None,
                               merge_dtype=torch.float16 if dt else None)
        port.load_state_dict(state_dict_from_jax(v), strict=True)
        out["jax", name] = float(loss), {n: sd[n].numpy() for n, _ in port.named_parameters()}
        state = create_train_state(port)
        metrics = train_step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
        assert metrics["grad_norm"].dtype == metrics["loss"].dtype == torch.float32
        assert all(p.grad.dtype == torch.float32 for p in port.parameters())
        out["port", name] = (metrics["loss"].item(),
                             {n: p.grad.numpy().copy() for n, p in port.named_parameters()})
        out["port", name, "grad_norm"] = metrics["grad_norm"].item()
    return out


@pytest.mark.parametrize("what", ["loss", "grad_max", "grad_median"])
def test_bf16_step_matches_jax_witness(steps, what):
    port = _distance(*steps["port", "bf16"], *steps["port", "f32"])
    witness = _distance(*steps["jax", "bf16"], *steps["jax", "f32"])
    # measured on the CPU: the JAX package's bf16 step is 1.0e-3 (loss),
    # 0.84 (largest gradient tensor, pred.bias, which XLA sums in bf16) and
    # 0.25 (median tensor) from its f32 step; the port's 4.4e-4, 0.34 and
    # 0.26 from its own. The two f32 steps are 4e-6 and 1.2e-2 / 8e-3 apart
    # (tests/test_torch_port_train.py says why)
    assert witness[what] > 0, witness  # bf16 rounded somewhere
    assert port[what] <= 2 * witness[what], (what, port, witness)


def test_bf16_step_is_near_the_f32_step_of_the_other_package(steps):
    # the port's bf16 step against the JAX package's f32 one: no farther than
    # twice the JAX bf16 step's own distance from it
    port = _distance(*steps["port", "bf16"], *steps["jax", "f32"])
    witness = _distance(*steps["jax", "bf16"], *steps["jax", "f32"])
    for k in port:
        assert port[k] <= 2 * witness[k], (k, port, witness)
    assert np.isfinite(steps["port", "bf16", "grad_norm"])


def test_train_cli_bf16_on_a_stanford_dataset(tmp_path, monkeypatch):
    # one epoch of --bf16 --merge_dtype f16 on real-format files: the
    # dataset's augmentations, the tensorboard log, the profiler trace of a
    # window of steps (steps 0-1 here), a validation pass and checkpoints
    pytest.importorskip("cv2")
    for cls in (datasets.StanfordDataset, jax_datasets.StanfordDataset):
        monkeypatch.setattr(cls, "pano_h", ERP[0])
        monkeypatch.setattr(cls, "pano_w", ERP[1])
    monkeypatch.setattr(train_cli, "PROFILE_STEPS", (0, 1))
    train = write_split(str(tmp_path), "stanford", 4, (128, 256))
    test = write_split(str(tmp_path), "matterport", 2, (128, 256))  # any two panoramas
    run = tmp_path / "run"
    argv = ["--dataset", "stanford", "--input_dir", str(tmp_path), "--trainfile", train,
            "--testfile", test, "--device", "cpu", "--erp_size", "64,128", "--patchsize", "32",
            "--batch", "2", "--workers", "1", "--epochs", "1", "--seed", "0",
            "--bf16", "--merge_dtype", "f16", "--save_path", str(run),
            "--tensorboard_path", str(tmp_path / "tb"), "--visualize_interval", "1",
            "--profile_dir", str(tmp_path / "prof")]
    args = train_cli.build_parser().parse_args(argv)
    history = train_cli.run_training(args)
    assert history["steps"] == 2 and np.isfinite(history["train_loss"]).all()
    assert len(history["val"]) == 1 and np.isfinite(history["val"][0]["abs_rel"])
    assert sorted(os.listdir(run / "ckpt")) == ["best.pt", "latest.pt"]
    sd = torch.load(run / "ckpt" / "latest.pt", weights_only=True)["model"]
    assert all(t.dtype == torch.float32 for k, t in sd.items() if t.is_floating_point())
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert (run / "run_config.json").exists()


def test_train_cli_overlays_an_upstream_checkpoint(tmp_path):
    # --checkpoint with an upstream-layout .pth (Conv3d kernels, module.
    # prefix, state_dict wrapper): every entry it has, before any step
    args = train_cli.build_parser().parse_args(
        ["--dataset", "synthetic", "--device", "cpu", "--erp_size", "64,128",
         "--patchsize", "32", "--seed", "1", "--checkpoint", str(tmp_path / "up.pth")])
    donor = train_cli.build_model(args, torch.device("cpu"))
    upstream = {"module." + k: (t[..., None] if t.ndim == 4 else t)
                for k, t in donor.state_dict().items() if not k.startswith("up_proj.")}
    torch.save({"state_dict": upstream}, tmp_path / "up.pth")
    model = train_cli.build_model(args, torch.device("cpu"))
    state = create_train_state(model)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    train_cli.restore_or_overlay(args, state)
    for k, t in model.state_dict().items():
        want = before[k] if k.startswith("up_proj.") else donor.state_dict()[k]
        torch.testing.assert_close(t, want, rtol=0, atol=0, msg=k)
