"""Upstream checkpoints: the port's importer against the JAX package's.

The ``.pth`` files are written by the JAX package's exporter
(models/torch_export.py: export_oneshot_checkpoint /
export_iterative_checkpoint + save_torch_checkpoint): the upstream layout,
Conv3d (k, k, 1) kernels, Linear (out, in), BatchNorm statistics, bare or
with the DataParallel ``module.`` prefix and the ``state_dict`` wrapper. The
upstream models have the full ResNet-34 and six transformer layers, so the
forward comparison runs them at full depth, 256x512 / patch 128 (the token
width of the upstream checkpoint, 512), batch 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.models import SphericalFusionIterative as JaxIterative
from omnifusion_tpu.models import torch_import as jax_import
from omnifusion_tpu.models.torch_export import (
    export_iterative_checkpoint,
    export_oneshot_checkpoint,
    save_torch_checkpoint,
)
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_torch.cli.common import read_state_dict
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, state_dict_from_jax
from omnifusion_torch.models.torch_import import import_torchvision_resnet34, merge_pretrained
from omnifusion_torch.projection import ProjectionSpec

from test_torch_port_model import _rel, _tame_heads

ERP, PATCH = (256, 512), 128
MODELS = {"oneshot": (JaxSphericalFusion, SphericalFusion, export_oneshot_checkpoint,
                      jax_import.import_oneshot_checkpoint),
          "iterative": (JaxIterative, SphericalFusionIterative, export_iterative_checkpoint,
                        jax_import.import_iterative_checkpoint)}
WRAPPERS = ("bare", "module_prefix", "state_dict_wrapper", "both")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the suite runs in several worker processes at once
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per model: the JAX variables (tamed heads; at full depth the head
    kernels take 1e-3), and the
    upstream-layout .pth files of each wrapper."""
    cache = {}

    def get(name, erp=ERP, patch=PATCH):
        if (name, erp) not in cache:
            jax_cls, _, export, _ = MODELS[name]
            rgb = np.zeros((1, *erp, 3), np.float32)
            kw = dict(spec=JaxSpec.create(erp, patch, (80, 80), 4))
            v = _tame_heads(jax.jit(jax_cls(**kw).init)(jax.random.PRNGKey(5), rgb))
            for head in ("pred", "weight_pred"):
                v["params"]["trunk"][head]["kernel"] *= 0.02
            sd = export(v)
            root = tmp_path_factory.mktemp(f"{name}_{erp[0]}")
            files = {}
            for wrapper in WRAPPERS:
                d = {("module." + k if wrapper in ("module_prefix", "both") else k): x
                     for k, x in sd.items()}
                path = str(root / f"{wrapper}.pth")
                save_torch_checkpoint(path, d)
                if wrapper in ("state_dict_wrapper", "both"):
                    torch.save({"state_dict": torch.load(path, weights_only=True), "epoch": 3},
                               path)
                files[wrapper] = path
            cache[name, erp] = kw, v, files
        return cache[name, erp]

    return get


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_import_gives_the_ports_state_dict(exported, name, wrapper):
    _, v, files = exported(name)
    ours = read_state_dict(files[wrapper])  # what --checkpoint loads
    want = state_dict_from_jax(v)
    assert set(ours) == set(want)
    for k, t in want.items():
        assert ours[k].shape == t.shape and ours[k].dtype == t.dtype, k
        torch.testing.assert_close(ours[k], t, rtol=0, atol=0, msg=k)
    # the JAX importer reads the same file to the same weights
    theirs = state_dict_from_jax(
        MODELS[name][3](jax_import.load_torch_state_dict(files[wrapper])))
    for k, t in theirs.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(ours[k], t, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_from_the_file_matches_jax(exported, name):
    jax_cls, port_cls, _, jax_importer = MODELS[name]
    kw, _, files = exported(name)
    rgb = np.random.default_rng(0).random((1, *ERP, 3), dtype=np.float32)
    variables = jax_importer(jax_import.load_torch_state_dict(files["both"]))
    theirs = jax.jit(jax_cls(**kw, kernel_impl="pallas", resize_impl="pallas").apply)(
        variables, jnp.asarray(rgb))
    theirs = [np.asarray(t) for t in (theirs if isinstance(theirs, list) else [theirs])]

    model = port_cls(ProjectionSpec.create(ERP, PATCH, (80, 80), 4), device="cpu")
    assert not hasattr(model, "up_proj")  # patch 128: as in the upstream model
    model.load_state_dict(read_state_dict(files["both"]), strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(rgb))
    ours = [o.numpy() for o in (ours if isinstance(ours, list) else [ours])]
    assert len(ours) == len(theirs) == (2 if name == "iterative" else 1)
    for i, (o, t) in enumerate(zip(ours, theirs)):
        assert o.shape == t.shape == (1, *ERP, 1) and np.isfinite(o).all()
        assert (np.abs(t) > 1e-3).mean() > 0.5, i  # the heads are live
        rel = _rel(o, t)
        # the bounds of tests/test_torch_port_iterative.py at 256x512
        assert np.median(rel) < 1e-5, (i, np.median(rel))
        assert np.quantile(rel, 0.999) < 1e-4, (i, np.quantile(rel, 0.999))
        assert (rel > 0.05).mean() < 1e-4, (i, (rel > 0.05).mean())
        assert rel.max() < (1e-3 if i == 0 else 5e-3), (i, rel.max())


def test_checkpoint_without_up_proj(exported):
    # patch 32: the token width is 32, so the model has up_proj, which no
    # upstream checkpoint holds. A strict load fails, as the JAX forward of
    # the imported variables does; the partial load keeps the projection's
    # own init and takes everything else from the file
    erp, patch = (64, 128), 32
    kw, v, files = exported("oneshot", erp, patch)
    model = SphericalFusion(ProjectionSpec.create(erp, patch, (80, 80), 4), device="cpu")
    sd = read_state_dict(files["bare"])
    assert "up_proj.weight" in model.state_dict() and "up_proj.weight" not in sd
    with pytest.raises(RuntimeError, match="up_proj"):
        model.load_state_dict(sd, strict=True)
    imported = jax_import.import_oneshot_checkpoint(jax_import.load_torch_state_dict(files["bare"]))
    with pytest.raises(Exception, match="up_proj"):
        JaxSphericalFusion(**kw).apply(imported, jnp.zeros((1, *erp, 3)))
    init = {k: t.clone() for k, t in model.state_dict().items()}
    model.load_state_dict(merge_pretrained(model.state_dict(), sd), strict=True)
    after = model.state_dict()
    for k, t in after.items():
        torch.testing.assert_close(t, init[k] if k.startswith("up_proj.") else sd[k],
                                   rtol=0, atol=0, msg=k)


def _torchvision_resnet34(seed: int, model) -> dict:
    """A torchvision resnet34 state dict (2-D kernels, an fc head) with the
    encoder shapes of ``model`` and random values."""
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
          for k, t in model.state_dict().items()
          if k.startswith(("conv1.", "bn1.", "layer")) and t.is_floating_point()}
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_torchvision_partial_load_matches_jax(exported):
    erp, patch = (64, 128), 32
    _, v, _ = exported("oneshot", erp, patch)
    model = SphericalFusion(ProjectionSpec.create(erp, patch, (80, 80), 4), device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    tv = _torchvision_resnet34(6, model)
    pretrained = import_torchvision_resnet34({"module." + k: t for k, t in tv.items()})
    assert "fc.weight" not in pretrained and len(pretrained) == len(tv) - 2
    merged = merge_pretrained(model.state_dict(), pretrained)

    jax_pre = jax_import.import_torchvision_resnet34({k: t.numpy() for k, t in tv.items()})
    jax_merged = {c: jax_import.merge_pretrained({c: v[c]}, {c: jax_pre[c]})[c]
                  for c in ("params", "batch_stats")}
    want = state_dict_from_jax(jax_merged)
    for k, t in merged.items():
        torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)
    changed = {k for k in merged if not torch.equal(merged[k], model.state_dict()[k])}
    assert changed and all(k.startswith(("conv1.", "bn1.", "layer")) for k in changed)


def test_partial_load_raises_on_a_shape_mismatch():
    sd = {"conv1.weight": torch.zeros(64, 3, 7, 7), "bn1.weight": torch.ones(64)}
    with pytest.raises(ValueError, match="shape mismatch at conv1.weight"):
        merge_pretrained(sd, {"conv1.weight": torch.zeros(64, 3, 3, 3)})
    assert merge_pretrained(sd, {"other": torch.zeros(2)}).keys() == sd.keys()
