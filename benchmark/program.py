"""The system under test: the port's models and train state, built as its
entry points build them (``cli/common.py: build_model``, ``cli/train.py``),
with the benchmark's weights loaded.

The only module of the benchmark, with the modes, that imports the port
(``omnifusion_torch``).
"""

from __future__ import annotations

import torch

DTYPES = {"f32": None, "bf16": torch.bfloat16, "f16": torch.float16}


def build_model(cfg, precision: dict, state: dict, device):
    """The configuration's model with ``precision`` = {"trunk": ...,
    "merge": ...} ("f32" is the parameters' own type; TF32 convolutions
    are PyTorch's default on the card), ``state`` loaded strictly."""
    from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative
    from omnifusion_torch.projection import ProjectionSpec

    spec = ProjectionSpec.create(cfg["erp_size"], cfg["patch_size"], cfg["fov"], cfg["nrows"])
    kw = dict(dtype=DTYPES[precision["trunk"]], merge_dtype=DTYPES[precision["merge"]],
              device=device, depth=cfg["transformer_depth"], num_heads=cfg["num_heads"],
              encoder_stages=[tuple(s) for s in cfg["encoder_stages"]])
    if cfg["model"] == "iterative":
        model = SphericalFusionIterative(spec, num_iters=cfg["num_iters"], **kw)
    else:
        model = SphericalFusion(spec, **kw)
    model.load_state_dict(state, strict=True)
    return model


def depths(out) -> list[torch.Tensor]:
    """Each pass's depth (B, H, W, 1) of a forward; the last is the one
    served."""
    return list(out) if isinstance(out, (list, tuple)) else [out]


def train_state(model, traffic):
    """``training.create_train_state`` with the mix's recipe."""
    from omnifusion_torch.training import create_train_state

    r = traffic["recipe"]
    return create_train_state(model, r["lr"], r["weight_decay"], r["t_0"], r["t_mult"],
                              r["steps_per_epoch"])


def train_step(state, batch):
    from omnifusion_torch.training import train_step as step

    return step(state, batch)
