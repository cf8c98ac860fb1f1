"""The port's modules vs their JAX counterparts, through state_dict_from_jax.

One small JAX SphericalFusion is initialised, its normalisation parameters
and running statistics are randomised (so that a swapped mean/var or
scale/bias shows), and its variables are carried into the port's model with
strict=True. Each JAX submodule then runs on its own subtree of those
variables, and the port's module of the same name on the same numpy input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.models import spherical_fusion as jax_sf
from omnifusion_tpu.models.layers import ConvBnReLU as JaxConvBnReLU
from omnifusion_tpu.models.layers import max_pool_3x3_s2 as jax_max_pool
from omnifusion_tpu.models.resnet import ResNet34Encoder as JaxResNet
from omnifusion_tpu.models.transformer import TransformerCascade as JaxTransformer
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection.spec import build_pers2equi_grids as jax_p2e
from omnifusion_torch.models import SphericalFusion, confidence_merge, state_dict_from_jax
from omnifusion_torch.models.layers import max_pool_3x3_s2
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.spec import build_pers2equi_grids

ERP, PATCH, DEPTH = (64, 128), 32, 2
STAGES = ((64, 1, 1), (128, 2, 2), (256, 1, 2), (512, 1, 2))


def _randomize(variables, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a)
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if name in ("mean", "bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def models():
    jspec = JaxSpec.create(ERP, PATCH, (80, 80), 4)
    jmodel = jax_sf.SphericalFusion(spec=jspec, depth=DEPTH, encoder_stages=STAGES)
    rgb = jnp.zeros((1, *ERP, 3), jnp.float32)
    variables = _randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), rgb))
    model = SphericalFusion(
        ProjectionSpec.create(ERP, PATCH, (80, 80), 4),
        depth=DEPTH,
        encoder_stages=STAGES,
        device="cpu",
    )
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, model.eval()


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        tree = variables[col]
        for key in path:
            tree = tree.get(key) if tree is not None else None
        if tree is not None:
            out[col] = tree
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_resnet_encoder(models):
    variables, model = models
    rng = np.random.default_rng(1)
    x = rng.random((3, PATCH, PATCH, 3), dtype=np.float32)
    pf = rng.random((3, PATCH // 4, PATCH // 4, 64), dtype=np.float32)
    want = JaxResNet(stages=STAGES).apply(
        _sub(variables, "trunk", "encoder"), jnp.asarray(x), False, jnp.asarray(pf)
    )
    with torch.no_grad():
        got = model.encode(_nchw(x), _nchw(pf))
    assert set(got) == set(want)
    # f32 on both sides; summation order differs inside the convs (measured
    # max abs 4e-6 on features up to ~7)
    for name in want:
        np.testing.assert_allclose(
            _nhwc(got[name]), np.asarray(want[name]), rtol=1e-5, atol=1e-5, err_msg=name
        )


def test_transformer(models):
    variables, model = models
    p = model.spec.n_patches
    tok = np.random.default_rng(2).standard_normal((2, p, model.emb)).astype(np.float32)
    want = JaxTransformer(model.emb, p, depth=DEPTH, num_heads=4).apply(
        _sub(variables, "trunk", "transformer"), jnp.asarray(tok)
    )
    with torch.no_grad():
        got = model.transformer(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_conv_bn_relu_and_mlp_points(models):
    variables, model = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 4, 512)).astype(np.float32)
    want = JaxConvBnReLU(256).apply(_sub(variables, "trunk", "de_conv0_0"), jnp.asarray(x))
    with torch.no_grad():
        got = model.de_conv0_0(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)

    geo = rng.standard_normal((3, 8, 8, 5)).astype(np.float32)
    want = jax_sf.MlpPoints().apply(_sub(variables, "mlp_points"), jnp.asarray(geo))
    with torch.no_grad():
        got = model.mlp_points(_nchw(geo))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_max_pool(models):
    x = np.random.default_rng(4).standard_normal((2, 9, 7, 3)).astype(np.float32) - 5.0
    want = jax_max_pool(jnp.asarray(x))
    got = _nhwc(max_pool_3x3_s2(_nchw(x)))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "f16"])
def test_confidence_merge(dtype):
    spec = ProjectionSpec.create(ERP, PATCH, (80, 80), 4)
    jgrids = jax_p2e(JaxSpec.create(ERP, PATCH, (80, 80), 4))
    rng = np.random.default_rng(5)
    shape = (2, spec.n_patches, PATCH, PATCH)
    pred = (rng.random(shape) * 8).astype(np.float32)
    conf = rng.random(shape).astype(np.float32)
    conf[0] = 0.0  # every pixel of the first panorama takes the den <= 1e-8 guard
    jdt, tdt = {"f32": (jnp.float32, None), "f16": (jnp.float16, torch.float16)}[dtype]
    want = jax_sf.confidence_merge(
        jnp.asarray(pred[..., None]), jnp.asarray(conf[..., None]), jgrids, dtype=jdt, impl="pallas"
    )
    got = confidence_merge(
        torch.from_numpy(pred), torch.from_numpy(conf), build_pers2equi_grids(spec), dtype=tdt
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, *ERP, 1)
    assert (got[0] == 0).all()
    # f16: the JAX merge falls back to its XLA path below 128 source rows,
    # which rounds the blend through f16 while the port accumulates in f32;
    # the tolerance of the JAX suite's own f16-merge comparison
    # (tests/test_pallas_blend.py:189-191)
    tol = 1e-5 if dtype == "f32" else 5e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
