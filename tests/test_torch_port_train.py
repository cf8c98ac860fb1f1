"""The training slice: losses, schedule, train and eval steps, checkpoints and
the train entry point, held against the JAX package on the CPU.

Weights: the JAX init at 64x128/p32 with one-block stages and a depth-1
transformer, carried across by state_dict_from_jax (strict). The JAX model
runs the configuration the port ports: kernel_impl="pallas_full" (its blends
and their backward fall back to the XLA paths below 128 source rows, which
the JAX suite holds equal to the kernels) and the training default
resize_impl="conv".

Precision of the reference in train mode: the JAX BatchNorm takes the batch
variance as E[x^2] - E[x]^2 in f32 (models/layers.py:59-65), whose
cancellation puts up to 5e-2 of relative error on its own f32 gradients at
this size, against the port run in float64, while the port's f32 gradients
stay within 5e-3 of it and within a quarter of the reference's distance
(the "float64" case below). So the tight gradient check runs with the
BatchNorms on their running statistics, and the train step is checked at
the reference's own precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnifusion_tpu.evaluation.meters import MetricAccumulator as JaxAccumulator
from omnifusion_tpu.evaluation.metrics import compute_depth_metrics as jax_metrics
from omnifusion_tpu.losses.direct import berhu_loss as jax_berhu
from omnifusion_tpu.losses.direct import l1_loss as jax_l1
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.training import cosine_warm_restarts as jax_schedule
from omnifusion_tpu.training import make_optimizer as jax_optimizer
from omnifusion_tpu.training.trainer import _forward_loss
from omnifusion_torch.cli import train as train_cli
from omnifusion_torch.evaluation import MetricAccumulator, compute_depth_metrics
from omnifusion_torch.losses import berhu_loss, l1_loss
from omnifusion_torch.models import SphericalFusion, init_weights, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import (
    CheckpointManager,
    create_train_state,
    cosine_warm_restarts,
    eval_step,
    forward_loss,
    train_step,
)

ERP, PATCH = (64, 128), 32
ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
LR, WD, T0, T_MULT, STEPS_PER_EPOCH = 1e-4, 0.01, 5, 2, 3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the suite runs in several worker processes at once: torch's default of
    # one thread per core in each of them oversubscribes the CPU
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _batch(seed: int, b: int = 2):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, *ERP, 1)) > 0.2).astype(np.float32)
    depth = (rng.random((b, *ERP, 1)) * 7 + 0.3).astype(np.float32) * mask
    return {"rgb": rng.random((b, *ERP, 3), dtype=np.float32), "depth": depth, "mask": mask}


def _port_model(device="cpu"):
    spec = ProjectionSpec.create(ERP, PATCH, (80, 80), 4)
    return SphericalFusion(spec, depth=1, encoder_stages=ONE_BLOCK, device=device)


def _tame_heads(variables):
    # as tests/test_torch_port_model.py: keeps the ReLU depth and the sigmoid
    # confidence in their live range under random weights
    v = jax.tree_util.tree_map(np.array, variables)
    for head in ("pred", "weight_pred"):
        v["params"]["trunk"][head]["kernel"] *= 0.05
    v["params"]["trunk"]["pred"]["bias"] += 2.0
    return v


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(ours: np.ndarray, theirs: np.ndarray) -> float:
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


@pytest.fixture(scope="module")
def jax_run():
    """One JAX train step and one gradient with the BatchNorms on their
    running statistics, from the same init and batch."""
    batch = _batch(0)
    kw = dict(spec=JaxSpec.create(ERP, PATCH, (80, 80), 4), depth=1, encoder_stages=ONE_BLOCK)
    init = jax.jit(JaxSphericalFusion(**kw).init)
    v = _tame_heads(init(jax.random.PRNGKey(3), jnp.asarray(batch["rgb"][:1])))
    model = JaxSphericalFusion(**kw, kernel_impl="pallas_full")
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    @jax.jit
    def run(params, stats):
        (loss, (new_stats, pred)), grads = jax.value_and_grad(
            lambda p: _forward_loss(model, p, stats, jb, True), has_aux=True
        )(params)
        tx = jax_optimizer(LR, WD, T0, T_MULT, steps_per_epoch=STEPS_PER_EPOCH)
        updates, _ = tx.update(grads, tx.init(params), params)
        # the same loss with the BatchNorms on the post-step running stats
        eval_loss, eval_grads = jax.value_and_grad(
            lambda p: jax_berhu(
                model.apply({"params": p, "batch_stats": new_stats}, jb["rgb"], train=False),
                jb["depth"], jb["mask"],
            )
        )(params)
        return dict(
            loss=loss, grads=grads, new_stats=new_stats, pred_mean=jnp.mean(pred),
            grad_norm=optax.global_norm(grads), new_params=optax.apply_updates(params, updates),
            eval_loss=eval_loss, eval_grads=eval_grads,
        )

    out = _np(run(v["params"], v["batch_stats"]))
    return v, batch, out


@pytest.fixture(scope="module")
def port_step(jax_run):
    v, batch, _ = jax_run
    model = _port_model()
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    state = create_train_state(model, LR, WD, T0, T_MULT, STEPS_PER_EPOCH)
    metrics = train_step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return state, metrics, grads


@pytest.fixture(scope="module")
def port_f64_grads(jax_run):
    v, batch, _ = jax_run
    model = _port_model().double()
    model.geo = model.geo.double()
    sd = {k: t.double() if t.is_floating_point() else t for k, t in state_dict_from_jax(v).items()}
    model.load_state_dict(sd, strict=True)
    loss, _ = forward_loss(model, {k: torch.from_numpy(x).double() for k, x in batch.items()})
    loss.backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _jax_sd(out, params_key):
    return state_dict_from_jax({"params": out[params_key], "batch_stats": out["new_stats"]})


def test_gradients_match_jax(jax_run):
    # BatchNorms on the JAX step's running statistics on both sides: the
    # whole backward, the projections' transposed blend and the upsample's
    # adjoint included, at f32 rounding
    v, batch, out = jax_run
    model = _port_model()
    model.load_state_dict(_jax_sd({**out, "params": v["params"]}, "params"), strict=True)
    model.eval()
    b = {k: torch.from_numpy(x) for k, x in batch.items()}
    loss = berhu_loss(model(b["rgb"]), b["depth"], b["mask"])
    loss.backward()
    assert abs(loss.item() / float(out["eval_loss"]) - 1) < 1e-5
    want = _jax_sd({**out, "eval_grads": out["eval_grads"]}, "eval_grads")
    rels = {n: _rel(p.grad.numpy(), want[n].numpy()) for n, p in model.named_parameters()}
    # The merge divides by the blended confidence, so it hardly moves under a
    # uniform shift of the confidence logits: the gradient of weight_pred.bias
    # is a sum of nearly cancelling terms (its norm is ~1e-3 of
    # weight_pred.weight's) and keeps only ~1e-3 of relative precision.
    assert rels.pop("weight_pred.bias") < 1e-2
    assert max(rels.values()) < 1e-4, sorted(rels.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("what", ["loss", "grads", "float64", "bn_stats", "params"])
def test_train_step_matches_jax(jax_run, port_step, port_f64_grads, what):
    _, _, out = jax_run
    state, metrics, grads = port_step
    if what == "float64":
        # both f32 gradients against the port in float64 (its blends and
        # upsamples then compute in float64 too): the port's own rounding is
        # an order of magnitude below the reference's
        want = _jax_sd(out, "grads")
        ours = max(_rel(grads[n], g) for n, g in port_f64_grads.items())
        theirs = max(_rel(want[n].numpy(), g) for n, g in port_f64_grads.items())
        assert ours < 5e-3 and theirs < 5e-2 and ours < theirs / 4, (ours, theirs)
    elif what == "loss":
        assert abs(metrics["loss"].item() / float(out["loss"]) - 1) < 1e-5
        assert abs(metrics["pred_mean"].item() / float(out["pred_mean"]) - 1) < 1e-5
        assert abs(metrics["grad_norm"].item() / float(out["grad_norm"]) - 1) < 1e-2
    elif what == "grads":
        # the reference's own f32 precision in train mode (module docstring)
        want = _jax_sd(out, "grads")
        rels = {n: _rel(g, want[n].numpy()) for n, g in grads.items()}
        assert max(rels.values()) < 5e-2, sorted(rels.items(), key=lambda kv: -kv[1])[:5]
        assert np.median(list(rels.values())) < 1e-2
    elif what == "bn_stats":
        # one momentum-0.1 update with the unbiased batch variance, for every
        # BatchNorm of the trunk and of mlp_points
        want = _jax_sd(out, "new_params")
        sd = state.model.state_dict()
        keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert any(k.startswith("mlp_points") for k in keys)
        for k in keys:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    else:
        # The first AdamW update is about lr * sign(g). Where the two
        # gradients could disagree in sign the parameters may differ by 2 lr,
        # so compare where |g| is above the noise floor: 10 times the
        # difference between the two packages' gradients at that element, and
        # 100 times AdamW's eps, where g / (|g| + eps) is within 1e-3 of its
        # sign whatever that difference.
        want, jgrads = _jax_sd(out, "new_params"), _jax_sd(out, "grads")
        compared = 0
        for n, p in state.model.named_parameters():
            g = jgrads[n].numpy()
            live = (np.abs(g) > 10 * np.abs(grads[n] - g)) & (np.abs(g) > 100 * 1e-8)
            compared += int(live.sum())
            np.testing.assert_allclose(
                p.detach().numpy()[live], want[n].numpy()[live], rtol=1e-6, atol=1e-3 * LR, err_msg=n
            )
        assert compared > 0.5 * sum(p.numel() for p in state.model.parameters())


def test_berhu_and_l1_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.random((3, 8, 16, 1), dtype=np.float32) * 6
    gt = rng.random((3, 8, 16, 1), dtype=np.float32) * 6
    mask = (rng.random((3, 8, 16, 1)) > 0.3).astype(np.float32)
    want, jgrad = jax.value_and_grad(jax_berhu)(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    p = torch.from_numpy(pred).requires_grad_()
    got = berhu_loss(p, torch.from_numpy(gt), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(
        l1_loss(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask)).item(),
        float(jax_l1(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))), rtol=1e-6,
    )


@pytest.mark.parametrize("t_mult", [1, 2])
def test_schedule_matches_jax(t_mult):
    ours = cosine_warm_restarts(LR, T0, t_mult, steps_per_epoch=STEPS_PER_EPOCH)
    theirs = jax_schedule(LR, T0, t_mult, steps_per_epoch=STEPS_PER_EPOCH)
    for step in range(40):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-5, err_msg=str(step))


@pytest.mark.parametrize("median_scale", [True, False])
def test_eval_metrics_match_jax(median_scale):
    rng = np.random.default_rng(2)
    pred = rng.random((2, 16, 32, 1), dtype=np.float32) * 5 + 0.05
    gt = rng.random((2, 16, 32, 1), dtype=np.float32) * 5 + 0.05
    mask = (rng.random((2, 16, 32, 1)) > 0.25).astype(np.float32)
    mask[0, 0, 0, 0] = 1.0 - mask[0, 0, 0, 0]  # an odd or even count either way is fine
    theirs, jn = jax_metrics(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask), median_scale)
    ours, n = compute_depth_metrics(
        torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask), median_scale
    )
    assert float(n) == float(jn)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].item(), float(v), rtol=2e-6, err_msg=k)
    acc, jacc = MetricAccumulator(), JaxAccumulator()
    for w in (3.0, 5.0):
        acc.update({k: t.item() for k, t in ours.items()}, w)
        jacc.update({k: float(t) for k, t in theirs.items()}, w)
    for k, v in jacc.averages().items():
        np.testing.assert_allclose(acc.averages()[k], v, rtol=2e-6)


def test_param_groups_follow_the_caffe_rules_and_freezing():
    model = _port_model()
    init_weights(model, 0)
    state = create_train_state(model, LR, WD, caffe_bias_rules=True, frozen_prefixes=("conv1",))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step(state, {k: torch.from_numpy(x) for k, x in _batch(3).items()})
    lr = state.schedule(0)
    for n, p in model.named_parameters():
        if n.startswith("conv1"):
            torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
            continue
        # the first AdamW update: lr_g * (g / (|g| + eps) + wd_g * p)
        bias = n.rsplit(".", 1)[-1] == "bias"
        lr_g, wd_g = (2 * lr, 0.0) if bias else (lr, WD)
        g = p.grad
        want = before[n] * (1 - lr_g * wd_g) - lr_g * g / (g.abs() + 1e-8)
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=1e-9, msg=n)


def test_checkpoint_resumes_exactly(tmp_path):
    batches = [{k: torch.from_numpy(x) for k, x in _batch(s).items()} for s in (4, 5)]

    def fresh():
        model = _port_model()
        init_weights(model, 1)
        return create_train_state(model, LR, WD, T0, T_MULT, 1)

    straight = fresh()
    for b in batches:
        train_step(straight, b)

    first = fresh()
    train_step(first, batches[0])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first, "latest")
    assert mgr.exists("latest") and not mgr.exists("best")
    resumed = mgr.restore(fresh(), "latest")
    assert resumed.step == 1
    train_step(resumed, batches[1])
    for (n, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    for a, b in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        torch.testing.assert_close(a["exp_avg_sq"], b["exp_avg_sq"], rtol=0, atol=0)


def test_train_cli_runs_and_resumes_on_cpu(tmp_path):
    # 2 steps (one per epoch), one validation after the last, then a resumed
    # third epoch from the checkpoint the run wrote
    argv = ["--dataset", "synthetic", "--device", "cpu", "--erp_size", "64,128",
            "--patchsize", "32", "--batch", "2", "--synthetic_size", "2", "--workers", "1",
            "--epochs", "2", "--save_path", str(tmp_path / "run"), "--seed", "0"]
    history = train_cli.run_training(train_cli.build_parser().parse_args(argv))
    assert history["steps"] == 2 and len(history["train_loss"]) == 2
    assert np.isfinite(history["train_loss"]).all()
    assert len(history["val"]) == 1 and set(history["val"][0]) >= {"abs_rel", "d1", "epoch"}
    ckpt = tmp_path / "run" / "ckpt"
    assert (ckpt / "latest.pt").exists() and (ckpt / "best.pt").exists()
    assert (tmp_path / "run" / "result_log.csv").read_text().count("\n") == 2
    argv[argv.index("--epochs") + 1] = "3"
    history = train_cli.run_training(
        train_cli.build_parser().parse_args(argv + ["--checkpoint", str(ckpt / "latest.pt")])
    )
    assert history["steps"] == 3 and len(history["train_loss"]) == 1


def test_train_step_on_cpu_launches_no_kernel():
    from omnifusion_torch.ops.quad_blend import quad_blend, quad_spread
    from omnifusion_torch.ops.upsample import up2x, up2x_adjoint

    counts = lambda: (quad_blend.launches, quad_spread.launches, up2x.launches,
                      up2x_adjoint.launches)
    model = _port_model()
    init_weights(model, 2)
    before = counts()
    metrics = train_step(create_train_state(model), {k: torch.from_numpy(x) for k, x in _batch(6).items()})
    assert np.isfinite(metrics["loss"].item()) and counts() == before
    assert all(p.grad is not None for p in model.parameters())
    m, n, pred = eval_step(model, {k: torch.from_numpy(x) for k, x in _batch(7).items()})
    assert pred.shape == (2, *ERP, 1) and float(n) > 0 and not model.training
