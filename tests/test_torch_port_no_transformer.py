"""--no_transformer: the legacy variant without global patch fusion
(network_360d.py:330-335), JAX ``use_transformer=False`` against the port's,
forward on the CPU, one-shot and iterative.

The trunk has no token projection, no transformer and no up_proj, so the
parameter tree, the converted state dict and the port's modules must agree
on which keys exist (strict load)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.models import SphericalFusionIterative as JaxIterative
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_torch.cli.common import add_common_args, build_model
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec

from test_torch_port_model import ONE_BLOCK, _rel, _tame_heads

ERP, PATCH = (64, 128), 32
FUSION_KEYS = ("down.", "down1.", "transformer.", "up_proj.")


@pytest.mark.parametrize("iterative", [False, True], ids=["oneshot", "iterative"])
def test_forward_without_transformer_matches_jax(iterative):
    rgb = np.random.default_rng(0).random((2, *ERP, 3), dtype=np.float32)
    kw = dict(spec=JaxSpec.create(ERP, PATCH, (80, 80), 4), use_transformer=False)
    port_kw = dict(use_transformer=False, device="cpu")
    if iterative:
        jax_cls, port_cls = JaxIterative, SphericalFusionIterative
    else:  # the one-shot model's shallow stages keep the test short
        jax_cls, port_cls = JaxSphericalFusion, SphericalFusion
        kw["encoder_stages"] = port_kw["encoder_stages"] = ONE_BLOCK
    variables = _tame_heads(jax.jit(jax_cls(**kw).init)(jax.random.PRNGKey(3), rgb[:1]))
    assert not {"down", "transformer", "up_proj"} & set(variables["params"]["trunk"])
    theirs = jax.jit(jax_cls(**kw, kernel_impl="pallas", resize_impl="pallas").apply)(
        variables, jnp.asarray(rgb))
    theirs = [np.asarray(t) for t in (theirs if iterative else [theirs])]

    model = port_cls(ProjectionSpec.create(ERP, PATCH, (80, 80), 4), **port_kw)
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(model.state_dict())
    assert not any(k.startswith(FUSION_KEYS) for k in sd)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(rgb))
    ours = [o.numpy() for o in (ours if iterative else [ours])]
    assert len(ours) == len(theirs) == (2 if iterative else 1)
    for i, (o, t) in enumerate(zip(ours, theirs)):
        assert o.shape == t.shape == (2, *ERP, 1) and np.isfinite(o).all()
        assert (np.abs(t) > 1e-3).mean() > 0.5, i  # the heads are live
        rel = _rel(o, t)
        # the bounds of tests/test_torch_port_model.py and _iterative.py
        assert np.median(rel) < 1e-5, (i, np.median(rel))
        assert np.quantile(rel, 0.999) < 1e-4, (i, np.quantile(rel, 0.999))
        assert (rel > 0.05).mean() < 1e-4, (i, (rel > 0.05).mean())
        assert rel.max() < (1e-3 if i == 0 else 5e-3), (i, rel.max())


@pytest.mark.parametrize("model", ["oneshot", "iterative"])
def test_cli_flag_builds_the_variant(model):
    parser = argparse.ArgumentParser()
    add_common_args(parser, train=True)
    flags = ["--device", "cpu", "--erp_size", "64,128", "--patchsize", "32", "--model", model]
    with_fusion = build_model(parser.parse_args(flags))
    without = build_model(parser.parse_args(flags + ["--no_transformer"]))
    assert not without.use_transformer and with_fusion.use_transformer
    keys = set(without.state_dict())
    assert keys == {k for k in with_fusion.state_dict() if not k.startswith(FUSION_KEYS)}
    assert any(k.startswith(FUSION_KEYS) for k in with_fusion.state_dict())
