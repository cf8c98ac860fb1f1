"""The system under test: the port's models and train state, built as its
entry points build them (``cli/common.py: build_model``, ``cli/train.py``),
with the benchmark's weights loaded; and the port's span recorder.

What differs between model kinds is in ``benchmark/models/<model>.py``,
found by the configuration's ``model`` (``kind``): ``build`` (the model,
``build_model`` below with the kind's class), ``outputs`` (what a forward
serves, one tensor a pass, the last the one served) and ``train_step``
(the port's step on the generator's batch).

The only modules of the benchmark, with the modes and the kinds, that
import the port (``omnifusion_torch``), and only inside functions.
"""

from __future__ import annotations

import importlib

import torch

DTYPES = {"f32": None, "bf16": torch.bfloat16, "f16": torch.float16}


def kind(cfg):
    """The module of the configuration's model kind:
    ``benchmark/models/<model>.py``."""
    return importlib.import_module(f"benchmark.models.{cfg['model']}")


def build_model(model_class, cfg, precision: dict, state: dict, device, **kw):
    """``model_class`` (a port model) of the configuration with its trunk
    in ``precision["trunk"]`` ("f32" is the parameters' own type; TF32
    convolutions are PyTorch's default on the card), ``state`` loaded
    strictly; ``kw`` the class's own arguments (a merge's type, passes)."""
    from omnifusion_torch.projection import ProjectionSpec

    spec = ProjectionSpec.create(cfg["erp_size"], cfg["patch_size"], cfg["fov"], cfg["nrows"])
    model = model_class(spec, dtype=DTYPES[precision["trunk"]], device=device,
                        depth=cfg["transformer_depth"], num_heads=cfg["num_heads"],
                        encoder_stages=[tuple(s) for s in cfg["encoder_stages"]], **kw)
    model.load_state_dict(state, strict=True)
    return model


def train_state(model, traffic):
    """``training.create_train_state`` with the mix's recipe."""
    from omnifusion_torch.training import create_train_state

    r = traffic["recipe"]
    return create_train_state(model, r["lr"], r["weight_decay"], r["t_0"], r["t_mult"],
                              r["steps_per_epoch"])


def recording():
    """``utils.profiling.recording()``: the port's spans and counters
    recorded for the duration (its ``Recording`` is the context's
    value)."""
    from omnifusion_torch.utils.profiling import recording as port_recording

    return port_recording()
