"""``remat`` (``--remat``): the encoder rematerialized, on the CPU.

The JAX models wrap their encoder in ``nn.remat``
(omnifusion_tpu/models/spherical_fusion.py:115); the port's wrap its call
in ``torch.utils.checkpoint`` with ``parallel.remat_contexts``, so that the
recompute in the backward normalizes as the forward did and leaves the
BatchNorms' running statistics and batch counts as the forward left them.

- One train step with ``remat=True`` against ``remat=False``, float64, for
  the one-shot and the iterative models (whose two passes each recompute
  their encoder): the loss, every gradient, every running statistic and
  ``num_batches_tracked`` equal to rounding.
- The same with the BatchNorms made global (``GlobalBatchNorm2d``, one
  process): equal, and the recompute runs no all-reduce of statistics.
- One f32 step with ``remat=True`` against the JAX ``remat=True`` step at
  the bounds of tests/test_torch_port_train.py::test_train_step_matches_jax.
- ``--remat`` reaches the model from every CLI.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.training.trainer import _forward_loss
from omnifusion_torch.cli import common, train_sem
from omnifusion_torch.models import (
    SphericalFusion,
    SphericalFusionIterative,
    init_weights,
    state_dict_from_jax,
)
from omnifusion_torch.parallel import convert_global_batchnorm, sync_bn
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, train_step

ERP, PATCH = (64, 128), 32
ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
LR, WD, T0, T_MULT, STEPS_PER_EPOCH = 1e-4, 0.01, 5, 2, 3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _batch(seed: int = 0, b: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, *ERP, 1)) > 0.2).astype(np.float32)
    depth = (rng.random((b, *ERP, 1)) * 7 + 0.3).astype(np.float32) * mask
    return {"rgb": rng.random((b, *ERP, 3), dtype=np.float32), "depth": depth, "mask": mask}


def _model(kind: str, remat: bool, dtype=torch.float64) -> torch.nn.Module:
    spec = ProjectionSpec.create(ERP, PATCH, (80, 80), 4)
    kw = dict(depth=1, encoder_stages=ONE_BLOCK, device="cpu", remat=remat)
    cls = SphericalFusionIterative if kind == "iterative" else SphericalFusion
    model = init_weights(cls(spec, **kw), 3)
    with torch.no_grad():  # running statistics off (0, 1), and live heads
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(7)) * 0.1)
        model.pred.weight.mul_(0.05)
        model.weight_pred.weight.mul_(0.05)
        model.pred.bias.add_(2.0)
    return model.to(dtype)


def _step(model: torch.nn.Module, kind: str, dtype=torch.float64) -> dict:
    state = create_train_state(model, LR, WD, T0, T_MULT, STEPS_PER_EPOCH)
    batch = {k: torch.from_numpy(v).to(dtype) for k, v in _batch().items()}
    m = train_step(state, batch, kind != "iterative")
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


@pytest.fixture(scope="module")
def steps():
    return {(kind, remat): _step(_model(kind, remat), kind)
            for kind in ("oneshot", "iterative") for remat in (False, True)}


@pytest.mark.parametrize("kind", ["oneshot", "iterative"])
@pytest.mark.parametrize("what", ["loss", "grads", "running_stats", "num_batches_tracked"])
def test_remat_step_equals_the_plain_step_f64(steps, kind, what):
    plain, remat = steps[kind, False], steps[kind, True]
    if what == "loss":
        assert abs(remat["loss"] / plain["loss"] - 1) < 1e-13
        assert abs(remat["grad_norm"] / plain["grad_norm"] - 1) < 1e-12
    elif what == "grads":
        assert set(remat["grads"]) == set(plain["grads"])
        rels = {n: _rel(g, plain["grads"][n]) for n, g in remat["grads"].items()
                if plain["grads"][n].norm() > 0}
        assert max(rels.values()) < 1e-12, sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    elif what == "running_stats":
        keys = [k for k in plain["state"] if k.endswith(("running_mean", "running_var"))]
        assert any(k.startswith("layer1") for k in keys)
        for k in keys:
            assert float((remat["state"][k] - plain["state"][k]).abs().max()) < 1e-14, k
    else:
        counts = {k: int(v) for k, v in remat["state"].items() if k.endswith("num_batches_tracked")}
        want = {k: int(v) for k, v in plain["state"].items() if k.endswith("num_batches_tracked")}
        # one update per train forward of each BatchNorm: the iterative
        # model's trunk runs twice
        assert counts == want and counts["bn1.num_batches_tracked"] == (
            2 if kind == "iterative" else 1)


def test_remat_with_global_batchnorms_reduces_statistics_once(monkeypatch):
    calls = []
    real = sync_bn.all_reduce_

    def counted(t, op="sum"):
        calls.append(t.numel())
        return real(t, op)

    monkeypatch.setattr(sync_bn, "all_reduce_", counted)
    out, reduces = {}, {}
    for remat in (False, True):
        calls.clear()
        model = convert_global_batchnorm(_model("oneshot", remat))
        assert sum(isinstance(m, sync_bn.GlobalBatchNorm2d) for m in model.modules()) > 10
        out[remat] = _step(model, "oneshot")
        reduces[remat] = list(calls)
    # forward: [sum x, n] and sum (x - mean)^2 per BatchNorm, backward one
    # reduction each; the recompute adds none
    assert reduces[True] == reduces[False] and reduces[False]
    assert abs(out[True]["loss"] / out[False]["loss"] - 1) < 1e-13
    for k, v in out[False]["state"].items():
        assert float((out[True]["state"][k].double() - v.double()).abs().max()) < 1e-12, k
    for n, g in out[False]["grads"].items():
        assert _rel(out[True]["grads"][n], g) < 1e-12, n


@pytest.fixture(scope="module")
def jax_remat_step():
    batch = _batch()
    kw = dict(spec=JaxSpec.create(ERP, (PATCH, PATCH), (80, 80), 4), depth=1,
              encoder_stages=ONE_BLOCK)
    v = jax.tree_util.tree_map(np.array, jax.jit(JaxSphericalFusion(**kw).init)(
        jax.random.PRNGKey(3), jnp.asarray(batch["rgb"][:1])))
    for head in ("pred", "weight_pred"):
        v["params"]["trunk"][head]["kernel"] *= 0.05
    v["params"]["trunk"]["pred"]["bias"] += 2.0
    model = JaxSphericalFusion(**kw, kernel_impl="pallas_full", remat=True)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    @jax.jit
    def run(params, stats):
        (loss, (new_stats, _)), grads = jax.value_and_grad(
            lambda p: _forward_loss(model, p, stats, jb, True), has_aux=True)(params)
        return dict(loss=loss, grads=grads, new_stats=new_stats,
                    grad_norm=optax.global_norm(grads))

    out = jax.tree_util.tree_map(np.asarray, run(v["params"], v["batch_stats"]))
    return v, batch, out


@pytest.mark.parametrize("what", ["loss", "grads", "bn_stats"])
def test_remat_step_matches_the_jax_remat_step(jax_remat_step, what):
    v, batch, out = jax_remat_step
    spec = ProjectionSpec.create(ERP, PATCH, (80, 80), 4)
    model = SphericalFusion(spec, depth=1, encoder_stages=ONE_BLOCK, device="cpu", remat=True)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    state = create_train_state(model, LR, WD, T0, T_MULT, STEPS_PER_EPOCH)
    m = train_step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
    if what == "loss":
        assert abs(m["loss"].item() / float(out["loss"]) - 1) < 1e-5
        assert abs(m["grad_norm"].item() / float(out["grad_norm"]) - 1) < 1e-2
    elif what == "grads":
        # the reference's own f32 precision in train mode
        # (tests/test_torch_port_train.py's docstring)
        want = state_dict_from_jax({"params": out["grads"], "batch_stats": out["new_stats"]})
        rels = {n: _rel(p.grad, want[n]) for n, p in model.named_parameters()}
        assert max(rels.values()) < 5e-2, sorted(rels.items(), key=lambda kv: -kv[1])[:5]
        assert np.median(list(rels.values())) < 1e-2
    else:
        want = state_dict_from_jax({"params": v["params"], "batch_stats": out["new_stats"]})
        sd = model.state_dict()
        keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert any(k.startswith("layer1") for k in keys)
        for k in keys:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_remat_flag_reaches_the_model(train):
    parser = argparse.ArgumentParser()
    common.add_common_args(parser, train=train)
    args = parser.parse_args(["--device", "cpu", "--erp_size", "64,128", "--patchsize", "32",
                              "--remat", "--model", "iterative"])
    assert common.build_model(args).remat
    args.remat, args.model = False, "oneshot"
    assert not common.build_model(args).remat


def test_train_sem_builds_its_model_with_remat(monkeypatch, tmp_path):
    seen = {}

    def build(*a, **kw):
        seen.update(kw)
        raise SystemExit("built")

    monkeypatch.setattr(train_sem, "SphericalFusionSeg", build)
    with pytest.raises(SystemExit, match="built"):
        train_sem.main(["--dataset", "synthetic", "--device", "cpu", "--erp_size", "64,128",
                        "--patchsize", "32", "--mesh", "none", "--remat",
                        "--save_path", str(tmp_path)])
    assert seen["remat"] is True
