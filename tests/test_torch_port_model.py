"""The one-shot slice end to end: JAX SphericalFusion vs the PyTorch port.

Same numpy input, same weights (JAX init, carried across by
state_dict_from_jax with strict=True), both on the CPU. The JAX model runs
the configuration the port ports: kernel_impl="pallas" (the blend falls back
to its XLA path below 128 source rows, which the JAX suite holds equal to the
kernel) and resize_impl="pallas" (the up2x kernel in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_torch.models import SphericalFusion, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec

ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))


def _tame_heads(variables):
    """Random weights saturate the heads: most of the ReLU depth is 0 and
    the sigmoid confidence is 1 to f32 precision, which would hide both the
    depth and the merge's weighting. Scaling both head kernels and offsetting
    the depth bias keeps the two heads in their live range."""
    v = jax.tree_util.tree_map(np.array, variables)
    for head in ("pred", "weight_pred"):
        v["params"]["trunk"][head]["kernel"] *= 0.05
    v["params"]["trunk"]["pred"]["bias"] += 2.0
    return v


def _rel(ours, theirs):
    return np.abs(ours - theirs) / np.maximum(np.abs(theirs), 1e-3)


@pytest.mark.parametrize(
    "erp,patch,depth",
    [
        ((64, 128), 32, 1),  # token width 32: the up_proj branch
        # token width 128 from a 2x2 layer4: the up_proj branch where the
        # token's channel-major order matters (a 1x1 layer4 cannot tell)
        ((128, 256), 64, 1),
        ((256, 512), 128, 2),  # token width 512 == layer4 width: the add branch
    ],
)
def test_oneshot_matches_jax(erp, patch, depth):
    rgb = np.random.default_rng(0).random((2, *erp, 3), dtype=np.float32)
    kw = dict(spec=JaxSpec.create(erp, patch, (80, 80), 4), depth=depth, encoder_stages=ONE_BLOCK)
    # the resize has no parameters: init through the default conv resize
    init = jax.jit(JaxSphericalFusion(**kw).init)
    variables = _tame_heads(init(jax.random.PRNGKey(3), jnp.asarray(rgb[:1])))
    jmodel = JaxSphericalFusion(**kw, kernel_impl="pallas", resize_impl="pallas")
    theirs = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(rgb)))

    model = SphericalFusion(
        ProjectionSpec.create(erp, patch, (80, 80), 4),
        depth=depth,
        encoder_stages=ONE_BLOCK,
        device="cpu",
    )
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert hasattr(model, "up_proj") == (patch != 128)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(rgb)).numpy()

    assert ours.shape == theirs.shape == (2, *erp, 1)
    assert np.isfinite(ours).all()
    rel = _rel(ours, theirs)
    assert (np.abs(theirs) > 1e-3).mean() > 0.5  # the heads are live
    # The bounds of the upstream parity test (tests/test_reference_parity.py:
    # 85-87), tightened: median 100x, 99.9% quantile 500x, plus a maximum.
    # Both sides compute in f32 on the CPU with equal tables and weights, so
    # the differences are summation-order rounding through the network
    # (measured: median 4e-7, 99.9% 3e-6, max 4e-6), and no pixel sits on a
    # blend threshold that the two packages' tables decide differently (the
    # upstream test's reason for its loose bounds).
    assert np.median(rel) < 1e-5, np.median(rel)
    assert np.quantile(rel, 0.999) < 1e-4, np.quantile(rel, 0.999)
    assert (rel > 0.05).mean() < 1e-4, (rel > 0.05).mean()
    assert rel.max() < 1e-3, rel.max()
