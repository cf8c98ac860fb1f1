"""The port against the JAX package at the flagship configuration on the CPU:
512x1024 ERP, patch 128, fov 80, nrows 4 (and the uniform 4x6 grid for the
one-shot model), the full ResNet-34 and the 6-layer transformer, one
panorama, f32, the same weights (the JAX init, heads tamed to the features
that reach them, carried across by state_dict_from_jax with strict=True).

Marked ``slow``: the suite's other tests hold the same models at 64x128
(both) and 256x512 (the depth model): tests/test_torch_port_model.py and
tests/test_torch_port_segmentation.py.
The bounds are the upstream parity test's (tests/test_reference_parity.py:
85-87), the serving bounds that PERF.md states for the port, plus a share
of live outputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.models import SphericalFusionSeg as JaxSeg
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_torch.models import SphericalFusion, SphericalFusionSeg, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec

from test_torch_port_model import _rel

FLAGSHIP = ((512, 1024), 128)
MODELS = {"oneshot": (JaxSphericalFusion, SphericalFusion, {}),
          "segmentation": (JaxSeg, SphericalFusionSeg, {"num_classes": 13})}
# test id -> (model, patch layout)
CASES = {"oneshot": ("oneshot", "rings"), "segmentation": ("segmentation", "rings"),
         "oneshot_uniform_4x6": ("oneshot", "uniform:4x6")}
# the RMS of each head's kernel term over the patches, and the depth bias
HEAD_RMS = {"pred": 0.5, "weight_pred": 1.0}
DEPTH_BIAS = 2.0


def _tame_heads_to_features(jmodel, variables, rgb):
    """Random weights saturate the heads, and tests/test_torch_port_model.py's
    fixed scale (x0.05) does not hold at full depth: the features that reach
    the heads grow through the full ResNet-34 on the BatchNorms' initial
    statistics, and 90% of the one-shot depth is then ReLU'd to zero. So each
    head kernel is scaled until its term over the patches (the 3x3 conv of
    de_conv4_0's output, taken from the JAX forward) has the RMS of
    HEAD_RMS, and the depth (or logit) bias is raised by DEPTH_BIAS: the
    depth stays positive and the sigmoid confidence in its live range."""
    v = jax.tree_util.tree_map(np.array, variables)
    _, inter = jax.jit(functools.partial(
        jmodel.apply, capture_intermediates=lambda mdl, _: mdl.name == "de_conv4_0",
        mutable=["intermediates"],
    ))(variables, jnp.asarray(rgb))
    feats = inter["intermediates"]["trunk"]["de_conv4_0"]["__call__"][0]
    trunk = v["params"]["trunk"]
    for head, rms in HEAD_RMS.items():
        term = jax.lax.conv_general_dilated(
            feats, jnp.asarray(trunk[head]["kernel"]), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        trunk[head]["kernel"] *= rms / float(jnp.sqrt(jnp.mean(jnp.square(term))))
    trunk["pred"]["bias"] += DEPTH_BIAS
    return v


def forward_parity(name: str, erp, patch: int, layout: str = "rings") -> dict:
    """One panorama through the JAX model and the port's with the same
    weights; the relative differences' statistics, asserted."""
    jcls, cls, kw = MODELS[name]
    rgb = np.random.default_rng(5).random((1, *erp, 3), dtype=np.float32)
    jmodel = jcls(spec=JaxSpec.create(erp, patch, (80, 80), 4, layout=layout), **kw)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(11), jnp.asarray(rgb))
    variables = _tame_heads_to_features(jmodel, variables, rgb)
    theirs = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(rgb)))
    del jmodel
    model = cls(ProjectionSpec.create(erp, patch, (80, 80), 4, layout=layout), device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(rgb)).numpy()
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    rel = _rel(ours, theirs)
    stats = {"median": float(np.median(rel)), "q999": float(np.quantile(rel, 0.999)),
             "share": float((rel > 0.05).mean()), "live": float((np.abs(theirs) > 1e-3).mean())}
    assert stats["live"] > 0.5, stats  # the heads are live
    assert stats["median"] < 1e-3 and stats["q999"] < 0.05 and stats["share"] < 1e-4, stats
    return stats


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CASES))
def test_flagship_forward_matches_jax(case):
    name, layout = CASES[case]
    forward_parity(name, *FLAGSHIP, layout=layout)
