"""The bf16 serving recipe: JAX SphericalFusion(dtype=bf16, merge_dtype=f16)
against the port's, both on the CPU.

Same numpy input, same weights (JAX init with tamed heads, carried across by
state_dict_from_jax). The JAX model runs the configuration the port ports,
kernel_impl="pallas" and resize_impl="pallas", as tests/test_torch_port_model.py
runs it in f32. bf16 rounds at other places in the two frameworks (the order
of a convolution's sums decides which values cross a rounding boundary), so
the port is held to the JAX package's own bf16 witness: its distance from
the JAX f32 forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import omnifusion_tpu.models.spherical_fusion as jax_sf
import omnifusion_torch.models.spherical_fusion as sf
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_torch.models import SphericalFusion, init_weights, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec

from test_torch_port_model import ONE_BLOCK, _rel, _tame_heads

CASES = [
    ((64, 128), 32, 1),  # token width 32: the up_proj branch
    ((256, 512), 128, 2),  # token width 512 == layer4 width: the add branch
]


def _setup(erp, patch, depth, batch=2):
    rgb = np.random.default_rng(0).random((batch, *erp, 3), dtype=np.float32)
    kw = dict(spec=JaxSpec.create(erp, patch, (80, 80), 4), depth=depth, encoder_stages=ONE_BLOCK)
    variables = _tame_heads(jax.jit(JaxSphericalFusion(**kw).init)(jax.random.PRNGKey(3), rgb[:1]))
    return rgb, kw, variables


def _port(erp, patch, depth, variables, **kw):
    model = SphericalFusion(
        ProjectionSpec.create(erp, patch, (80, 80), 4), depth=depth, encoder_stages=ONE_BLOCK,
        device="cpu", **kw,
    )
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


def _jax_from_port(state_dict, like):
    """The inverse of state_dict_from_jax: the port's ``state_dict`` as JAX
    variables shaped like ``like``. Every element of ``like`` is numbered,
    the numbers go through state_dict_from_jax, and each port value goes
    back to the element whose number lands on it."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    sizes = [int(np.size(x)) for x in leaves]
    starts = np.cumsum([0] + sizes)
    numbered = treedef.unflatten([
        np.arange(a, a + n, dtype=np.float64).reshape(np.shape(x))
        for a, n, x in zip(starts, sizes, leaves)])
    flat = np.full(starts[-1], np.nan, np.float32)
    for key, ids in state_dict_from_jax(numbered).items():
        if ids.is_floating_point():  # num_batches_tracked is the port's own
            flat[ids.numpy().astype(np.int64).ravel()] = state_dict[key].float().numpy().ravel()
    assert not np.isnan(flat).any()  # every element came back
    return treedef.unflatten(
        [flat[a:a + n].reshape(np.shape(x)) for a, n, x in zip(starts, sizes, leaves)])


def _stats(ours, ref):
    rel = _rel(ours, ref)
    return {"median": float(np.median(rel)), "q999": float(np.quantile(rel, 0.999)),
            "gt_0.05": float((rel > 0.05).mean())}


@pytest.mark.parametrize("erp,patch,depth", CASES)
def test_bf16_recipe_matches_jax(erp, patch, depth):
    rgb, kw, variables = _setup(erp, patch, depth)
    impl = dict(kernel_impl="pallas", resize_impl="pallas")
    jax_f32 = np.asarray(jax.jit(JaxSphericalFusion(**kw, **impl).apply)(variables, rgb))
    jax_bf16 = np.asarray(jax.jit(JaxSphericalFusion(
        **kw, **impl, dtype=jnp.bfloat16, merge_dtype=jnp.float16).apply)(variables, rgb))
    model = _port(erp, patch, depth, variables, dtype=torch.bfloat16, merge_dtype=torch.float16)
    with torch.no_grad():
        out = model(torch.from_numpy(rgb))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, *erp, 1)
    ours = out.numpy()
    assert np.isfinite(ours).all()
    assert (np.abs(jax_f32) > 1e-3).mean() > 0.5  # the heads are live

    witness = _stats(jax_bf16, jax_f32)  # the JAX package's own bf16 error
    port = _stats(ours, jax_f32)
    vs_jax_bf16 = _stats(ours, jax_bf16)
    # measured on the CPU: witness median 5.9e-4 / 3.2e-3, 99.9% 3.5e-3 /
    # 2.0e-2 (64x128 / 256x512); the port 5.5e-4 / 3.2e-3 and 3.3e-3 /
    # 1.9e-2 from JAX f32, 3.8e-4 / 2.5e-3 (median) from JAX bf16
    assert port["median"] <= 1.5 * witness["median"], (port, witness)
    assert port["q999"] <= 1.5 * witness["q999"], (port, witness)
    assert vs_jax_bf16["median"] <= 2 * witness["median"], (vs_jax_bf16, witness)
    for s in (port, vs_jax_bf16):
        assert s["gt_0.05"] < 1e-4, s


def _jax_dtypes(kw, variables, rgb, monkeypatch):
    """The dtypes of the JAX bf16 recipe's intermediates, from a trace."""
    seen = {}

    def name(x):
        return np.dtype(x.dtype).name

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        key = context.module.name
        if context.method_name != "__call__":
            return out
        if key == "trunk":
            seen.update(patches=name(args[0]), pred=name(out[0]), conf=name(out[1]))
        elif key == "encoder":
            seen["encoder"] = {k: name(v) for k, v in out.items()}
        elif key in ("mlp_points", "transformer", "de_conv4_0"):
            seen[key] = name(out)
        elif key == "de_conv0_0":
            seen["l4"] = name(args[0])  # the first upsample keeps l4's dtype
        return out

    real = jax_sf.pers2equi_cf

    def merge(src, *a, **k):
        seen["merge_src"] = name(src)
        return real(src, *a, **k)

    monkeypatch.setattr(jax_sf, "pers2equi_cf", merge)
    model = JaxSphericalFusion(**kw, kernel_impl="pallas", resize_impl="pallas",
                               dtype=jnp.bfloat16, merge_dtype=jnp.float16)

    def apply(v, x):
        with nn.intercept_methods(interceptor):
            return model.apply(v, x)

    seen["output"] = name(jax.eval_shape(apply, variables, rgb))
    return seen


def _port_dtypes(model, rgb, monkeypatch):
    """The same intermediates of the port's bf16 recipe, from hooks."""
    seen = {"encoder": {}}
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}

    def out_hook(key):
        return lambda mod, args, out: seen.__setitem__(key, name[out.dtype])

    for i in range(1, 5):
        getattr(model, f"layer{i}").register_forward_hook(
            lambda mod, args, out, i=i: seen["encoder"].__setitem__(f"layer{i}", name[out.dtype]))
    model.bn1.register_forward_hook(
        lambda mod, args, out: seen["encoder"].__setitem__("conv1", name[out.dtype]))
    for key in ("mlp_points", "transformer", "de_conv4_0"):
        getattr(model, key).register_forward_hook(out_hook(key))
    model.de_conv0_0.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("l4", name[args[0].dtype]))
    trunk = model.trunk

    def traced_trunk(x, pf, b):
        pred, conf = trunk(x, pf, b)
        seen.update(patches=name[x.dtype], pred=name[pred.dtype], conf=name[conf.dtype])
        return pred, conf

    monkeypatch.setattr(model, "trunk", traced_trunk)
    real = sf.pers2equi_cf

    def merge(src, *a, **k):
        seen["merge_src"] = name[src.dtype]
        return real(src, *a, **k)

    monkeypatch.setattr(sf, "pers2equi_cf", merge)
    with torch.no_grad():
        seen["output"] = name[model(torch.from_numpy(rgb)).dtype]
    return seen


@pytest.mark.parametrize("erp,patch,depth", CASES)
def test_bf16_dtype_flow_matches_jax(erp, patch, depth, monkeypatch):
    rgb, kw, variables = _setup(erp, patch, depth, batch=1)
    want = _jax_dtypes(kw, variables, rgb, monkeypatch)
    model = _port(erp, patch, depth, variables, dtype=torch.bfloat16, merge_dtype=torch.float16)
    got = _port_dtypes(model, rgb, monkeypatch)
    assert got == want
    # the casts of the JAX package (omnifusion_tpu/models): the trunk in
    # bf16, the transformer in f32 (flax promotes against f32 parameters);
    # l4 + tokens is f32 at patch 128 and bf16 through up_proj
    assert want["patches"] == want["mlp_points"] == want["de_conv4_0"] == "bfloat16"
    assert set(want["encoder"].values()) == {"bfloat16"}
    assert want["transformer"] == "float32" and want["output"] == "float32"
    assert want["l4"] == ("float32" if patch == 128 else "bfloat16")
    assert want["pred"] == want["conf"] == "bfloat16" and want["merge_src"] == "float16"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_without_confidence_matches_jax(dtype):
    erp, patch, depth = CASES[0]
    rgb, kw, variables = _setup(erp, patch, depth)
    jdt, tdt = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel = JaxSphericalFusion(**kw, kernel_impl="pallas", resize_impl="pallas", dtype=jdt)
    theirs = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, confidence=False))(variables, rgb))
    model = _port(erp, patch, depth, variables, dtype=tdt)
    with torch.no_grad():
        out = model(torch.from_numpy(rgb), confidence=False)
        weighted = model(torch.from_numpy(rgb))
    assert out.dtype == torch.float32 and tuple(out.shape) == theirs.shape == (2, *erp, 1)
    assert not torch.equal(out, weighted)
    rel = _rel(out.numpy(), theirs)
    if dtype == "f32":
        # the f32 bounds of tests/test_torch_port_model.py
        assert np.median(rel) < 1e-5 and np.quantile(rel, 0.999) < 1e-4 and rel.max() < 1e-3
    else:
        # the bf16 recipe's witness at this size (test_bf16_recipe_matches_jax)
        assert np.median(rel) < 2 * 5.9e-4 and (rel > 0.05).mean() < 1e-4


def test_init_weights_draws_at_the_jax_init_scale():
    """init_weights (the seeded weights of chip_smoke.py and bench.py) draws
    each tensor from the JAX init's family at its scale: constant tensors
    equal, random ones with the same mean and standard deviation within six
    standard errors of the two draws' difference."""
    erp, patch, depth = CASES[1]  # token width 512: pos_emb has 9216 elements
    rgb = np.zeros((1, *erp, 3), np.float32)
    kw = dict(spec=JaxSpec.create(erp, patch, (80, 80), 4), depth=depth, encoder_stages=ONE_BLOCK)
    theirs = state_dict_from_jax(jax.jit(JaxSphericalFusion(**kw).init)(jax.random.PRNGKey(3), rgb))
    model = SphericalFusion(ProjectionSpec.create(erp, patch, (80, 80), 4), depth=depth,
                            encoder_stages=ONE_BLOCK, device="cpu")
    ours = init_weights(model, 0).state_dict()
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got, want = ours[key].double(), want.double()
        if want.numel() == 1 or want.std() == 0:
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=key)
            continue
        tol = 6 / want.numel() ** 0.5
        assert abs(got.std() / want.std() - 1) < tol, (key, got.std(), want.std())
        assert abs(got.mean() - want.mean()) < tol * want.std(), (key, got.mean(), want.mean())


def test_bf16_witness_follows_the_weights():
    """The recipe's distance from f32 follows the weights' draw, for the JAX
    package's own recipe as for the port's: at the witness's configuration
    one draw of init_weights (seed 2, carried to JAX) keeps JAX's recipe
    near the witness of test_bf16_recipe_matches_jax, another (seed 1) puts
    a tenth of the pixels above 0.05. So a witness measured with one
    draw bounds no other, and chip_smoke.py, whose weights are another draw,
    holds the card to the CPU's distance with the same weights. With the
    same weights the port keeps to JAX's distance in median and 99.9%."""
    erp, patch, depth = CASES[1]
    rgb, kw, like = _setup(erp, patch, depth)
    impl = dict(kernel_impl="pallas", resize_impl="pallas")
    f32 = jax.jit(JaxSphericalFusion(**kw, **impl).apply)
    bf16 = jax.jit(JaxSphericalFusion(
        **kw, **impl, dtype=jnp.bfloat16, merge_dtype=jnp.float16).apply)
    witness = {}
    for seed in (2, 1):
        seeded = SphericalFusion(ProjectionSpec.create(erp, patch, (80, 80), 4), depth=depth,
                                 encoder_stages=ONE_BLOCK, device="cpu")
        variables = _tame_heads(_jax_from_port(init_weights(seeded, seed).state_dict(), like))
        jax_f32 = np.asarray(f32(variables, rgb))
        assert (np.abs(jax_f32) > 1e-3).mean() > 0.5  # the heads are live
        model = _port(erp, patch, depth, variables, dtype=torch.bfloat16,
                      merge_dtype=torch.float16)
        with torch.no_grad():
            ours = model(torch.from_numpy(rgb)).numpy()
        witness[seed] = _stats(np.asarray(bf16(variables, rgb)), jax_f32)
        port = _stats(ours, jax_f32)
        for k in ("median", "q999"):
            assert port[k] <= 1.5 * witness[seed][k], (seed, k, port, witness[seed])
    # measured on the CPU, seeds 2 / 1: JAX median 7.1e-3 / 4.4e-3, 99.9%
    # 3.6e-2 / 6.2, share above 0.05 9.2e-5 / 0.114; the port 6.4e-3 /
    # 3.9e-3, 3.4e-2 / 4.9, 0 / 0.107
    assert witness[1]["q999"] > 10 * witness[2]["q999"], witness
    assert witness[2]["gt_0.05"] < 1e-3 and witness[1]["gt_0.05"] > 0.05, witness


def test_bf16_recipe_at_full_depth():
    """At full depth (ResNet-34 stages, six transformer layers) and random
    weights, bf16 rounding alone moves a large share of the depth far from
    the f32 forward in the JAX package's own recipe, so the shallow
    witness's bound on that share (below 1e-4) cannot hold there; this is
    why chip_smoke.py holds the flagship recipe on the card to the plain
    versions' distance from f32 instead. The port keeps to JAX's distance."""
    erp, patch = CASES[1][:2]
    rgb = np.random.default_rng(0).random((1, *erp, 3), dtype=np.float32)
    kw = dict(spec=JaxSpec.create(erp, patch, (80, 80), 4))
    variables = _tame_heads(jax.jit(JaxSphericalFusion(**kw).init)(jax.random.PRNGKey(3), rgb))
    impl = dict(kernel_impl="pallas", resize_impl="pallas")
    jax_f32 = np.asarray(jax.jit(JaxSphericalFusion(**kw, **impl).apply)(variables, rgb))
    jax_bf16 = np.asarray(jax.jit(JaxSphericalFusion(
        **kw, **impl, dtype=jnp.bfloat16, merge_dtype=jnp.float16).apply)(variables, rgb))
    model = SphericalFusion(ProjectionSpec.create(erp, patch, (80, 80), 4),
                            dtype=torch.bfloat16, merge_dtype=torch.float16, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(rgb)).numpy()
    witness, port = _stats(jax_bf16, jax_f32), _stats(ours, jax_f32)
    # measured on the CPU: JAX 24% of the pixels above 0.05, the port 24%
    assert witness["gt_0.05"] > 1e-2, witness
    for k in ("median", "q999", "gt_0.05"):
        assert port[k] <= 1.5 * witness[k], (k, port, witness)
