"""Write the port's weights as upstream-format state dicts.

The port's counterpart of ``omnifusion_tpu/models/torch_export.py`` and the
inverse of ``models/torch_import.py``. The port's modules already sit at the
upstream checkpoint's names (models/convert.py), so the export changes
only the layouts the upstream model has and the port does not:

  - the conv kernels go back to Conv3d (O, I, k, k, 1) (convert_conv,
    model/spherical_model.py:122-143), except the ``mlp_points*`` convs,
    which are 2-D upstream;
  - a BatchNorm's ``num_batches_tracked`` is a 0-d int64 0, as the JAX
    package writes it;
  - ``up_proj`` (the token projection the port has where the patch is not
    128) is not written: the upstream model has none, and the JAX package
    does not write it either.

``import_checkpoint(export_oneshot_checkpoint(sd))`` gives ``sd`` back,
``num_batches_tracked`` and ``up_proj`` apart.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

StateDictOrModule = Union[torch.nn.Module, Mapping[str, torch.Tensor]]

# the keys that say which model a state dict is
_ONESHOT_KEYS = ("down.weight", "mlp_points.0.weight")
_ITERATIVE_KEYS = ("down1.weight", "mlp_points1.0.weight", "mlp_points2.0.weight")


def _upstream_layout(key: str, t: torch.Tensor) -> torch.Tensor:
    if key.endswith("num_batches_tracked"):
        return torch.tensor(0, dtype=torch.int64)
    if t.ndim == 4 and not key.startswith("mlp_points"):
        return t[..., None]
    return t


def _export(model: StateDictOrModule, keys: tuple, what: str) -> dict[str, torch.Tensor]:
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"not the state dict of {what}: no {missing}")
    return {k: _upstream_layout(k, v.detach().cpu()).contiguous()
            for k, v in sd.items() if not k.startswith("up_proj.")}


def export_oneshot_checkpoint(model: StateDictOrModule) -> dict[str, torch.Tensor]:
    """A SphericalFusion (or its state dict) -> the reference spherical_model
    state dict."""
    return _export(model, _ONESHOT_KEYS, "a one-shot model")


def export_iterative_checkpoint(model: StateDictOrModule) -> dict[str, torch.Tensor]:
    """A SphericalFusionIterative (or its state dict) -> the reference state
    dict."""
    return _export(model, _ITERATIVE_KEYS, "an iterative model")


def save_torch_checkpoint(path: str, sd: Mapping[str, torch.Tensor]) -> None:
    """Write a torch-loadable .pth file."""
    torch.save({k: v.contiguous() for k, v in sd.items()}, path)
