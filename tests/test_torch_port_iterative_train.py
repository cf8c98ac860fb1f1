"""The iterative-refinement model's train step, held against the JAX package
on the CPU, and its train entry point.

Weights: the JAX init of SphericalFusionIterative with tamed heads, carried
across by state_dict_from_jax (strict). The JAX step is
``make_train_step(model, confidence=False, iterative=True)``, the model in
the configuration the one-shot training tests run (kernel_impl="pallas_full",
resize_impl="conv"); the gradients come from the same ``_forward_loss``
that step differentiates. The loss is the mean of BerHu over the two
passes; under confidence=False the confidence head takes no gradient, on
either side.

Both sides run the one-block encoder stages and a depth-1 transformer, as
tests/test_torch_port_train.py does: the JAX model has no encoder_stages
argument, so its trunk is built with them through the test's
``_one_block_trunk``. At the full ResNet-34, f32 rounding alone moves some
gradients by 4e-3 with the BatchNorms on running statistics and by 1e-2 to
3.5e-2 in train mode against the port's own float64 run (measured at
64x128/p32 with seeded weights; the largest in layer3's BatchNorm biases,
and in train mode varying with the CPU thread count), above that file's
bounds. The
forward tests (tests/test_torch_port_iterative.py) run the full ResNet-34.

The bounds are tests/test_torch_port_train.py's, for the reason its
docstring gives: in train mode the JAX BatchNorm's f32 variance
(E[x^2] - E[x]^2) puts percents of error on its own gradients, so the tight
gradient check runs with the BatchNorms on their running statistics, and
the train step is checked at the reference's own precision and against the
port in float64.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import omnifusion_tpu.models.iterative as jax_iterative_mod
import omnifusion_torch.models.iterative as iterative_mod
from omnifusion_tpu.losses.direct import berhu_loss as jax_berhu
from omnifusion_tpu.models import SphericalFusionIterative as JaxIterative
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.training.trainer import TrainState as JaxTrainState
from omnifusion_tpu.training import make_optimizer as jax_optimizer
from omnifusion_tpu.training import make_train_step
from omnifusion_tpu.training.trainer import _forward_loss
from omnifusion_torch.cli import train as train_cli
from omnifusion_torch.losses import berhu_loss
from omnifusion_torch.models import SphericalFusionIterative, init_weights, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, forward_loss, train_step

from test_torch_port_model import ONE_BLOCK, _tame_heads

LR, WD, T0, T_MULT, STEPS_PER_EPOCH = 1e-4, 0.01, 5, 2, 3
CASES = [((64, 128), 32), pytest.param(((256, 512), 128), marks=pytest.mark.slow)]
# the confidence head: no gradient under confidence=False
NO_GRAD = ("weight_pred.weight", "weight_pred.bias")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _batch(erp, seed: int = 0, b: int = 2):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, *erp, 1)) > 0.2).astype(np.float32)
    depth = (rng.random((b, *erp, 1)) * 7 + 0.3).astype(np.float32) * mask
    return {"rgb": rng.random((b, *erp, 3), dtype=np.float32), "depth": depth, "mask": mask}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(ours: np.ndarray, theirs: np.ndarray) -> float:
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


def _port_model(erp, patch, num_iters=2):
    spec = ProjectionSpec.create(erp, patch, (80, 80), 4)
    return SphericalFusionIterative(spec, num_iters=num_iters, depth=1,
                                    encoder_stages=ONE_BLOCK, device="cpu")


def _sd(variables_like):
    return state_dict_from_jax(variables_like)


@contextlib.contextmanager
def _one_block_trunk():
    """The JAX iterative model with its trunk on the one-block stages (the
    module docstring); nothing of the JAX package changes outside it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_iterative_mod, "DepthTrunk",
                   functools.partial(jax_iterative_mod.DepthTrunk, encoder_stages=ONE_BLOCK))
        yield


@pytest.fixture(scope="module", params=CASES, ids=["64x128", "256x512"])
def jax_run(request):
    with _one_block_trunk():
        return _jax_run(*request.param)


def _jax_run(erp, patch):
    """One JAX train step (make_train_step), its gradients, and the
    gradients with the BatchNorms on the step's running statistics."""
    batch = _batch(erp)
    kw = dict(spec=JaxSpec.create(erp, patch, (80, 80), 4), depth=1)
    v = _tame_heads(jax.jit(JaxIterative(**kw).init)(jax.random.PRNGKey(3),
                                                      jnp.asarray(batch["rgb"][:1])))
    model = JaxIterative(**kw, kernel_impl="pallas_full")
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    tx = jax_optimizer(LR, WD, T0, T_MULT, steps_per_epoch=STEPS_PER_EPOCH)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    new_state, metrics = make_train_step(model, confidence=False, iterative=True,
                                         donate=False)(state, jb)

    @jax.jit
    def grads(params, stats, new_stats):
        # the step's gradients and update, from one compilation: where a
        # gradient element is near 0, its sign, and so AdamW's first update
        # there, may differ from one compilation to another
        g = jax.grad(lambda p: _forward_loss(model, p, stats, jb, False)[0])(params)
        updates, _ = tx.update(g, tx.init(params), params)
        # the same loss with the BatchNorms on the post-step running stats
        eval_loss, eval_g = jax.value_and_grad(lambda p: jnp.mean(jnp.stack([
            jax_berhu(pred, jb["depth"], jb["mask"]) for pred in model.apply(
                {"params": p, "batch_stats": new_stats}, jb["rgb"], train=False)])))(params)
        return g, optax.apply_updates(params, updates), eval_loss, eval_g

    g, new_params, eval_loss, eval_g = _np(grads(v["params"], v["batch_stats"],
                                                 new_state.batch_stats))
    out = dict(metrics=_np(metrics), grads=g, new_stats=_np(new_state.batch_stats),
               new_params=new_params, step_params=_np(new_state.params), eval_loss=eval_loss,
               eval_grads=eval_g)
    return (erp, patch), v, batch, out


@pytest.fixture(scope="module")
def port_step(jax_run):
    size, v, batch, _ = jax_run
    model = _port_model(*size)
    model.load_state_dict(_sd(v), strict=True)
    state = create_train_state(model, LR, WD, T0, T_MULT, STEPS_PER_EPOCH)
    metrics = train_step(state, {k: torch.from_numpy(x) for k, x in batch.items()},
                         confidence=False)
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return state, metrics, grads


@pytest.fixture(scope="module")
def port_f64_grads(jax_run):
    size, v, batch, _ = jax_run
    model = _port_model(*size).double()
    sd = {k: t.double() if t.is_floating_point() else t for k, t in _sd(v).items()}
    model.load_state_dict(sd, strict=True)
    loss, _ = forward_loss(model, {k: torch.from_numpy(x).double() for k, x in batch.items()},
                           confidence=False)
    loss.backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _jax_sd(out, params_key):
    return _sd({"params": out[params_key], "batch_stats": out["new_stats"]})


def _live(grads: dict) -> dict:
    for n in NO_GRAD:
        assert not np.any(grads.pop(n)), n
    return grads


def test_gradients_match_jax(jax_run):
    # BatchNorms on the JAX step's running statistics on both sides: the
    # whole backward, the feedback's channel-last transposed blend included,
    # at f32 rounding
    size, v, batch, out = jax_run
    model = _port_model(*size)
    model.load_state_dict(_jax_sd({**out, "params": v["params"]}, "params"), strict=True)
    model.eval()
    b = {k: torch.from_numpy(x) for k, x in batch.items()}
    preds = model(b["rgb"])
    loss = torch.stack([berhu_loss(p, b["depth"], b["mask"]) for p in preds]).mean()
    loss.backward()
    assert abs(loss.item() / float(out["eval_loss"]) - 1) < 1e-5
    want = _jax_sd({**out, "eval_grads": out["eval_grads"]}, "eval_grads")
    rels = _live({n: _rel(p.grad.numpy(), want[n].numpy()) for n, p in model.named_parameters()})
    # the one-shot file's bound at 64x128 (measured: largest 1.3e-5,
    # median 5.5e-6). At 256x512 about twice the measured (largest 1.1e-3,
    # in mlp_points2.0.weight; median 1.8e-4)
    bound, median = (1e-4, 1e-4) if size[0] == (64, 128) else (2e-3, 4e-4)
    assert max(rels.values()) < bound, sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    assert np.median(list(rels.values())) < median


@pytest.mark.parametrize("what", ["loss", "grads", "float64", "bn_stats", "params"])
def test_train_step_matches_jax(jax_run, port_step, port_f64_grads, what):
    _, _, _, out = jax_run
    state, metrics, grads = port_step
    if what == "float64":
        # both f32 gradients against the port in float64. Unlike the one-shot
        # model's, the port's are not the nearer: measured 9.0e-3 (port) and
        # 1.3e-3 (JAX) at 64x128, 1.2e-2 and 1.2e-2 at 256x512, the port's
        # largest in the transformer's; with the CPU's oneDNN convolutions
        # off, a one-pass step of the port is 4.4e-3 from its float64 run
        # (1.1e-2 with them)
        want = _jax_sd(out, "grads")
        live = _live(dict(port_f64_grads))
        ours = max(_rel(grads[n], g) for n, g in live.items())
        theirs = max(_rel(want[n].numpy(), g) for n, g in live.items())
        assert ours < 2e-2 and theirs < 5e-2, (ours, theirs)
    elif what == "loss":
        m = out["metrics"]  # make_train_step's
        assert abs(metrics["loss"].item() / float(m["loss"]) - 1) < 1e-5
        assert abs(metrics["pred_mean"].item() / float(m["pred_mean"]) - 1) < 1e-5
        assert abs(metrics["grad_norm"].item() / float(m["grad_norm"]) - 1) < 1e-2
    elif what == "grads":
        # the reference's own f32 precision in train mode (module docstring)
        want = _jax_sd(out, "grads")
        rels = _live({n: _rel(g, want[n].numpy()) for n, g in grads.items()})
        assert max(rels.values()) < 5e-2, sorted(rels.items(), key=lambda kv: -kv[1])[:5]
        assert np.median(list(rels.values())) < 1e-2
    elif what == "bn_stats":
        # make_train_step's: one momentum-0.1 update with the unbiased batch
        # variance, for every
        # BatchNorm of the trunk (updated by both passes) and of both
        # mlp_points; mlp_points1 runs once on the (P, 3, h/4, w/4) sphere
        want = _jax_sd(out, "new_params")
        sd = state.model.state_dict()
        keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert {k.split(".")[0] for k in keys} >= {"mlp_points1", "mlp_points2", "bn1"}
        for k in keys:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    else:
        # as tests/test_torch_port_train.py: compare where |g| is above the
        # noise floor of the two packages' gradients and of AdamW's eps, with
        # the update computed from the same gradients; make_train_step's
        # parameters are within one update of them
        want, jgrads = _jax_sd(out, "new_params"), _jax_sd(out, "grads")
        step = _jax_sd(out, "step_params")
        for n in want:
            if n.endswith(("weight", "bias", "pos_emb")):
                np.testing.assert_allclose(step[n].numpy(), want[n].numpy(), rtol=0,
                                           atol=2.5 * LR, err_msg=n)
        compared = 0
        for n, p in state.model.named_parameters():
            g = jgrads[n].numpy()
            # g / (|g| + eps) moves by eps |dg| / ((|g| + eps)(|g'| + eps)),
            # at most eps / (9 |g|) for |dg| < |g| / 10: within 1e-3 of
            # itself from |g| > 112 eps (an element at 100 eps, the one-shot
            # file's floor, measured 1.06e-3)
            live = (np.abs(g) > 10 * np.abs(grads[n] - g)) & (np.abs(g) > 120 * 1e-8)
            compared += int(live.sum())
            np.testing.assert_allclose(
                p.detach().numpy()[live], want[n].numpy()[live], rtol=1e-6, atol=1e-3 * LR,
                err_msg=n,
            )
        assert compared > 0.5 * sum(p.numel() for p in state.model.parameters())


@pytest.mark.parametrize("num_iters", [2, 3])
def test_feedback_carries_gradient(monkeypatch, num_iters):
    """No stop-gradient on the feedback: detaching the quarter-resolution
    equi2pers input changes the gradients of everything upstream of a
    pass's merge that feeds a later pass: the encoder and mlp_points1 (pass
    1), and from three passes on mlp_points2 (pass 2 feeds pass 3); with two
    passes mlp_points2 is not upstream of a feedback, and its gradient stays
    bit for bit."""
    erp = (64, 128)
    batch = {k: torch.from_numpy(x) for k, x in _batch(erp, seed=1).items()}
    model = init_weights(_port_model(erp, 32, num_iters), 5)
    sd = {k: t.clone() for k, t in model.state_dict().items()}
    e2p = iterative_mod.equi2pers

    def grads():
        model.load_state_dict(sd)
        model.zero_grad(set_to_none=True)
        loss, _ = forward_loss(model, batch, confidence=False)
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    kept = grads()
    monkeypatch.setattr(iterative_mod, "equi2pers",
                        lambda x, g: e2p(x.detach() if x.shape[-1] == 1 else x, g))
    cut = grads()
    for name in ("conv1.weight", "layer1.0.conv1.weight", "mlp_points1.0.weight"):
        assert not torch.allclose(kept[name], cut[name], rtol=1e-3, atol=0), name
    if num_iters == 2:
        assert torch.equal(kept["mlp_points2.0.weight"], cut["mlp_points2.0.weight"])
    else:
        assert not torch.allclose(kept["mlp_points2.0.weight"], cut["mlp_points2.0.weight"],
                                  rtol=1e-3, atol=0)


def test_train_cli_iterative_on_cpu(tmp_path):
    # 2 steps (one per epoch), a validation after the last, checkpoints; the
    # confidence-weighted merge with --confidence
    argv = ["--dataset", "synthetic", "--device", "cpu", "--erp_size", "64,128",
            "--patchsize", "32", "--batch", "2", "--synthetic_size", "2", "--workers", "1",
            "--epochs", "2", "--seed", "0", "--model", "iterative", "--iter", "2"]
    for confidence in (False, True):
        save = tmp_path / f"run{confidence}"
        args = train_cli.build_parser().parse_args(
            argv + ["--save_path", str(save)] + (["--confidence"] if confidence else []))
        history = train_cli.run_training(args)
        assert history["steps"] == 2 and len(history["train_loss"]) == 2
        assert np.isfinite(history["train_loss"]).all()
        assert len(history["val"]) == 1 and set(history["val"][0]) >= {"abs_rel", "d1"}
        assert (save / "ckpt" / "latest.pt").exists() and (save / "ckpt" / "best.pt").exists()
        keys = set(torch.load(save / "ckpt" / "latest.pt", weights_only=False)["model"])
        assert "down1.weight" in keys and "mlp_points2.0.weight" in keys
