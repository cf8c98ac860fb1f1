"""The multi-device wrap of a model: global BatchNorms, then DDP.

``wrap`` converts the model's BatchNorms to ``GlobalBatchNorm2d`` (except
those the model lists in ``REPLICATED_INPUT_NORMS``: BatchNorms whose input
is the same on every rank) and wraps it in ``DistributedDataParallel``,
which averages the gradients over the ranks. The buffers are not
broadcast from rank 0 before each forward: the global statistics leave
them equal on every rank. The parameters that no forward of the model uses
(``unused_parameters``: the iterative model's second embedding with one
pass) are left out of DDP's reduction rather than turning on
``find_unused_parameters``; every other parameter takes a gradient in
every step (the confidence head with ``confidence=False`` takes zeros,
through the fused heads' one convolution). ``unwrap`` gives the bare
module, whose state dict has no ``module.`` prefix.
"""

from __future__ import annotations

import inspect

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from omnifusion_torch.parallel.sync_bn import convert_global_batchnorm


def wrap(model: nn.Module, device) -> DistributedDataParallel:
    """``model``, its BatchNorms made global, in DDP on ``device`` (a
    process group must be up)."""
    device = torch.device(device)
    convert_global_batchnorm(model, keep=getattr(model, "REPLICATED_INPUT_NORMS", ()))
    unused = model.unused_parameters() if hasattr(model, "unused_parameters") else []
    if unused:
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(model, unused)
    # no buffer sync before each forward (newer torch names the switch anew)
    params = inspect.signature(DistributedDataParallel).parameters
    no_sync = ({"forward_sync_buffers": False} if "forward_sync_buffers" in params
               else {"broadcast_buffers": False})
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None, **no_sync,
    )


def unwrap(model: nn.Module) -> nn.Module:
    """The bare module of a DDP-wrapped model; any other model as it is."""
    return model.module if isinstance(model, DistributedDataParallel) else model
