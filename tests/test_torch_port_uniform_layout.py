"""The uniform patch layout ("uniform:RxC", the v2 grid of equi2pers) in the
port, held against the JAX package on the CPU: the patch centers, the spec,
the forward, merge and transposed tables, the round trip, the one-shot,
iterative and segmentation forwards and one train step (the float64
witness of tests/test_torch_port_train.py is not run here: at this layout
and 1 to 3 CPU threads, one f32 rounding in the train-mode decoder moves the
port's f32 gradients 3.7e-3 from its float64 run, 6.6e-5 at 4 threads, which
says nothing of the port's rounding).

The models run as tests/test_torch_port_model.py, test_torch_port_iterative.py,
test_torch_port_segmentation.py and test_torch_port_train.py run them on the
rings layout, with the same bounds, at 64x128/p32 and depth 1. The iterative
and segmentation forwards run the one-block encoder stages on both sides (the
JAX models' trunks are built with them through a monkeypatch, as the train
tests of those models do), to keep this file short; the one-shot forward and
the train step take them as an argument.
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
import omnifusion_tpu.models.segmentation as jax_seg_mod
from omnifusion_tpu.geometry.layout import uniform_patch_centers as jax_centers
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.models import SphericalFusionIterative as JaxIterative
from omnifusion_tpu.models import SphericalFusionSeg as JaxSeg
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection import equi2pers as jax_equi2pers
from omnifusion_tpu.projection import pers2equi as jax_pers2equi
from omnifusion_tpu.projection import spec as jax_spec
from omnifusion_tpu.training import make_optimizer as jax_optimizer
from omnifusion_tpu.training import make_train_step
from omnifusion_tpu.training.trainer import TrainState as JaxTrainState
from omnifusion_torch.geometry.layout import uniform_patch_centers
from omnifusion_torch.models import (
    SphericalFusion,
    SphericalFusionIterative,
    SphericalFusionSeg,
    state_dict_from_jax,
)
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection import build_equi2pers_grids, build_pers2equi_grids
from omnifusion_torch.projection import equi2pers, pers2equi
from omnifusion_torch.projection import spec as port_spec
from omnifusion_torch.training import create_train_state, train_step

from test_torch_port_model import ONE_BLOCK, _rel, _tame_heads
from test_torch_port_vjp_tables import FIELDS as VJP_FIELDS
from test_torch_port_vjp_tables import _check_ptr

ERP, PATCH, LAYOUT = (64, 128), 32, "uniform:4x6"
LR, WD, T0, T_MULT, STEPS_PER_EPOCH = 1e-4, 0.01, 5, 2, 3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the suite runs in several worker processes at once
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("rows,cols", [(4, 6), (6, 12), (1, 1), (3, 5)])
def test_uniform_patch_centers_match_jax(rows, cols):
    ours = uniform_patch_centers(rows, cols)
    assert ours.shape == (rows * cols, 2) and ours.dtype == np.float64
    np.testing.assert_array_equal(ours, jax_centers(rows, cols))


@pytest.mark.parametrize("layout", ["rings", "uniform:4x6", "uniform:6x12", "uniform:3x5"])
def test_spec_matches_jax(layout):
    ours = ProjectionSpec.create((128, 256), (32, 48), (80, 70), 4, layout=layout)
    theirs = JaxSpec.create((128, 256), (32, 48), (80, 70), 4, layout=layout)
    for o, t in ((ours, theirs), (ours.with_patch_scale(4), theirs.with_patch_scale(4))):
        assert repr(o) == repr(t) and o.layout == layout
        assert o.n_patches == t.n_patches
        for name in ("centers_deg", "centers_radians", "centers_normalized"):
            np.testing.assert_array_equal(getattr(o, name)(), getattr(t, name)(), err_msg=name)
    assert ours.with_patch_scale(4).patch_h == 8


@pytest.mark.parametrize("layout", ["uniform", "uniform:4", "uniform:4x6x2", "uniform:ax6",
                                    "uniform:0x6", "uniform:4x0"])
def test_spec_refuses_what_jax_cannot_build(layout):
    # the JAX spec takes the layout and fails at its first table; the port's
    # refuses it when it is made
    theirs = JaxSpec.create(ERP, PATCH, (80, 80), 4, layout=layout)
    with pytest.raises((ValueError, IndexError)):
        theirs.centers_radians()
    with pytest.raises(ValueError, match="uniform"):
        ProjectionSpec.create(ERP, PATCH, (80, 80), 4, layout=layout)


def _assert_vjp_equal(ours, theirs, n_in):
    for name, want in zip(VJP_FIELDS, theirs):
        want = np.asarray(want)
        np.testing.assert_array_equal(getattr(ours, name), want, err_msg=name)
        assert getattr(ours, name).dtype == want.dtype, name
    _check_ptr(ours, n_in)


@pytest.mark.parametrize("layout", ["uniform:4x6", "uniform:6x12"])
@pytest.mark.parametrize("erp,patch", [((64, 128), 16), ((128, 256), 32)])
def test_uniform_tables_match_jax(erp, patch, layout):
    spec = port_spec.ProjectionSpec.create(erp, patch, (80, 80), 4, layout=layout)
    jspec = JaxSpec.create(erp, patch, (80, 80), 4, layout=layout)
    n_erp, n_pers = spec.erp_h * spec.erp_w, spec.n_patches * spec.patch_h * spec.patch_w

    je, pe = jax_spec.build_equi2pers_grids(jspec), port_spec._build_equi2pers_grids(spec)
    np.testing.assert_array_equal(pe.idx, np.asarray(je.idx))
    np.testing.assert_allclose(pe.w4, np.asarray(je.w4), rtol=0, atol=1e-6)
    for name in ("xyz", "uv", "centers"):
        np.testing.assert_allclose(getattr(pe, name), np.asarray(getattr(je, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    _assert_vjp_equal(pe.vjp, je.vjp, n_erp)

    jp, pp = jax_spec.build_pers2equi_grids(jspec), port_spec._build_pers2equi_grids(spec)
    np.testing.assert_array_equal(pp.idx, np.asarray(jp.idx))
    np.testing.assert_allclose(pp.w4, np.asarray(jp.w4), rtol=0, atol=1e-6)
    # several patches overlap on every pixel: the merge is capped, with a tail
    assert pp.capped is not None and jp.capped is not None and pp.idx.shape[1] > 2
    c = pp.capped
    for name, want in zip(("idx", "w4", "tail_pix", "tail_idx", "tail_w"), jp.capped):
        want = np.asarray(want)
        if name.endswith("w4") or name == "tail_w":
            np.testing.assert_allclose(getattr(c, name), want, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(getattr(c, name), want, err_msg=name)
    np.testing.assert_array_equal(np.repeat(np.arange(n_erp), np.diff(c.tail_ptr)), c.tail_pix)
    _assert_vjp_equal(pp.vjp, jp.vjp, n_pers)


def test_uniform_layout_roundtrip():
    # tests/test_variants.py's round trip through the port, and equal to the
    # JAX package's at each step
    spec = ProjectionSpec.create((64, 128), (16, 16), (80, 80), nrows=4, layout="uniform:4x6")
    jspec = JaxSpec.create((64, 128), (16, 16), (80, 80), nrows=4, layout="uniform:4x6")
    assert spec.n_patches == 24
    img = np.array(jax.image.resize(
        jnp.asarray(np.random.default_rng(0).random((1, 8, 16, 3), np.float32)),
        (1, 64, 128, 3), "bilinear",
    ))
    pers = equi2pers(torch.from_numpy(img), build_equi2pers_grids(spec))
    assert tuple(pers.shape) == (1, 24, 16, 16, 3)
    rec = pers2equi(pers, build_pers2equi_grids(spec)).numpy()
    mid = rec[:, 16:48]
    rmse = np.sqrt(np.mean((mid - img[:, 16:48]) ** 2))
    assert rmse < 0.1, rmse
    jpers = jax_equi2pers(jnp.asarray(img), jax_spec.build_equi2pers_grids(jspec))
    np.testing.assert_allclose(pers.numpy(), np.asarray(jpers), rtol=0, atol=1e-6)
    jrec = jax_pers2equi(jpers, jax_spec.build_pers2equi_grids(jspec))
    np.testing.assert_allclose(rec, np.asarray(jrec), rtol=0, atol=1e-6)


@contextlib.contextmanager
def _one_block_trunks():
    """The JAX iterative and segmentation models with their trunks on the
    one-block stages (the module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_iterative_mod, jax_seg_mod):
            mp.setattr(mod, "DepthTrunk", functools.partial(mod.DepthTrunk,
                                                            encoder_stages=ONE_BLOCK))
        yield


def _assert_forward_parity(ours: np.ndarray, theirs: np.ndarray, max_rel: float = 1e-3):
    """tests/test_torch_port_model.py's bounds for the rings layout."""
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    assert (np.abs(theirs) > 1e-3).mean() > 0.5  # the heads are live
    rel = _rel(ours, theirs)
    assert np.median(rel) < 1e-5, np.median(rel)
    assert np.quantile(rel, 0.999) < 1e-4, np.quantile(rel, 0.999)
    assert (rel > 0.05).mean() < 1e-4, (rel > 0.05).mean()
    assert rel.max() < max_rel, rel.max()


MODELS = {
    "oneshot": (JaxSphericalFusion, SphericalFusion, {}),
    "iterative": (JaxIterative, SphericalFusionIterative, {}),
    "segmentation": (JaxSeg, SphericalFusionSeg, {"num_classes": 5}),
}


def _jax_kw(name: str) -> dict:
    jkw = dict(spec=JaxSpec.create(ERP, PATCH, (80, 80), 4, layout=LAYOUT), depth=1,
               **MODELS[name][2])
    if name == "oneshot":
        jkw["encoder_stages"] = ONE_BLOCK
    return jkw


@functools.lru_cache(maxsize=None)
def _variables(name: str) -> dict:
    """The tamed JAX init of a model (its values do not depend on the input's)."""
    with _one_block_trunks():
        init = jax.jit(MODELS[name][0](**_jax_kw(name)).init)
        return _tame_heads(init(jax.random.PRNGKey(3), np.zeros((1, *ERP, 3), np.float32)))


@pytest.mark.parametrize("name", list(MODELS))
def test_uniform_forward_matches_jax(name):
    jcls, cls, kw = MODELS[name]
    rgb = np.random.default_rng(0).random((2, *ERP, 3), dtype=np.float32)
    variables = _variables(name)
    impl = {} if name == "segmentation" else dict(kernel_impl="pallas", resize_impl="pallas")
    with _one_block_trunks():
        theirs = jax.jit(jcls(**_jax_kw(name), **impl).apply)(variables, jnp.asarray(rgb))
    sd = state_dict_from_jax(variables)
    assert tuple(sd["transformer.pos_emb"].shape) == (1, 24, 32)
    model = cls(ProjectionSpec.create(ERP, PATCH, (80, 80), 4, layout=LAYOUT), depth=1,
                encoder_stages=ONE_BLOCK, device="cpu", **kw)
    model.load_state_dict(sd, strict=True)
    assert model.n_patches == 24
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(rgb))
    if name == "iterative":
        assert len(ours) == len(theirs) == 2
        # pass 2 reads pass 1's depth: test_torch_port_iterative.py's maximum
        for i, (o, t) in enumerate(zip(ours, theirs)):
            _assert_forward_parity(o.numpy(), np.asarray(t), 1e-3 if i == 0 else 5e-3)
        assert np.abs(ours[1].numpy() - ours[0].numpy()).max() > 1e-3
    else:
        _assert_forward_parity(ours.numpy(), np.asarray(theirs))


def _batch(seed: int = 0, b: int = 2):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, *ERP, 1)) > 0.2).astype(np.float32)
    depth = (rng.random((b, *ERP, 1)) * 7 + 0.3).astype(np.float32) * mask
    return {"rgb": rng.random((b, *ERP, 3), dtype=np.float32), "depth": depth, "mask": mask}


def _grel(ours: np.ndarray, theirs: np.ndarray) -> float:
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


@pytest.fixture(scope="module")
def train_runs():
    """One step of the JAX package's make_train_step and of the port's
    train_step from the same tamed init and batch."""
    batch = _batch()
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    v = _variables("oneshot")
    jmodel = JaxSphericalFusion(**_jax_kw("oneshot"), kernel_impl="pallas_full")
    tx = jax_optimizer(LR, WD, T0, T_MULT, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
    jstate, jmetrics = make_train_step(jmodel, donate=False)(jstate, jb)
    # the step's own gradients: AdamW's first moment after one step is
    # (1 - b1) g, rounded once in f32 (a second compile of the gradient
    # alone rounds the near-cancelling ones differently)
    adam = jstate.opt_state[0]
    assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == 1
    jgrads = jax.tree_util.tree_map(
        lambda m: (np.asarray(m, np.float64) / np.float32(1 - 0.9)).astype(np.float32), adam.mu)
    out = jax.tree_util.tree_map(np.asarray, {
        "grads": jgrads, "params": jstate.params, "stats": jstate.batch_stats,
        "metrics": jmetrics,
    })

    model = SphericalFusion(ProjectionSpec.create(ERP, PATCH, (80, 80), 4, layout=LAYOUT),
                            depth=1, encoder_stages=ONE_BLOCK, device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    state = create_train_state(model, LR, WD, T0, T_MULT, STEPS_PER_EPOCH)
    metrics = train_step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return out, state, metrics, grads


@pytest.mark.parametrize("what", ["loss", "grads", "bn_stats", "params"])
def test_uniform_train_step_matches_jax(train_runs, what):
    # tests/test_torch_port_train.py's bounds, for the reasons its docstring
    # and test_train_step_matches_jax give
    out, state, metrics, grads = train_runs
    sd = lambda params: state_dict_from_jax({"params": params, "batch_stats": out["stats"]})  # noqa: E731
    if what == "loss":
        m = out["metrics"]
        assert abs(metrics["loss"].item() / float(m["loss"]) - 1) < 1e-5
        assert abs(metrics["pred_mean"].item() / float(m["pred_mean"]) - 1) < 1e-5
        assert abs(metrics["grad_norm"].item() / float(m["grad_norm"]) - 1) < 1e-2
    elif what == "grads":
        want = sd(out["grads"])
        rels = {n: _grel(g, want[n].numpy()) for n, g in grads.items()}
        assert max(rels.values()) < 5e-2, sorted(rels.items(), key=lambda kv: -kv[1])[:5]
        assert np.median(list(rels.values())) < 1e-2
    elif what == "bn_stats":
        want, got = sd(out["params"]), state.model.state_dict()
        keys = [k for k in got if k.endswith(("running_mean", "running_var"))]
        assert any(k.startswith("mlp_points") for k in keys)
        for k in keys:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    else:
        # test_train_step_matches_jax's comparison, on the elements where
        # its bound holds: two gradients g, g' of one sign that differ by at
        # most |g| / 10 give AdamW's first updates lr g / (|g| + eps) that
        # differ by at most lr eps |g - g'| / (|g| |g'|) <= lr eps / (9 |g|),
        # below its 1e-3 lr for |g| > 200 eps (at 100 eps, 1.1e-3 lr: one
        # element of layer4.0.conv1.weight passes it here by f32 rounding)
        want, jgrads = sd(out["params"]), sd(out["grads"])
        compared = 0
        for n, p in state.model.named_parameters():
            g = jgrads[n].numpy()
            live = (np.abs(g) > 10 * np.abs(grads[n] - g)) & (np.abs(g) > 200 * 1e-8)
            compared += int(live.sum())
            np.testing.assert_allclose(p.detach().numpy()[live], want[n].numpy()[live], rtol=1e-6,
                                       atol=1e-3 * LR, err_msg=n)
        assert compared > 0.5 * sum(p.numel() for p in state.model.parameters())


@pytest.mark.parametrize("layout,patches", [("uniform:4x6", 24), ("uniform:6x12", 72)])
def test_state_dict_from_jax_carries_the_uniform_pos_emb(layout, patches):
    # models/convert.py: the transformer's (1, P, emb) position embedding of
    # a uniform spec, into the port's model of the same spec (strict)
    if layout == LAYOUT:
        variables = _variables("oneshot")
    else:
        kw = dict(_jax_kw("oneshot"), spec=JaxSpec.create(ERP, PATCH, (80, 80), 4, layout=layout))
        variables = jax.jit(JaxSphericalFusion(**kw).init)(
            jax.random.PRNGKey(3), np.zeros((1, *ERP, 3), np.float32))
    sd = state_dict_from_jax(variables)
    assert tuple(sd["transformer.pos_emb"].shape) == (1, patches, 32)
    model = SphericalFusion(ProjectionSpec.create(ERP, PATCH, (80, 80), 4, layout=layout), depth=1,
                            encoder_stages=ONE_BLOCK, device="cpu")
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.transformer.pos_emb.detach().numpy(),
        np.asarray(variables["params"]["trunk"]["transformer"]["pos_emb"]))
