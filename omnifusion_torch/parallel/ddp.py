"""The multi-device wrap of a model: global BatchNorms, then DDP.

``wrap`` converts the model's BatchNorms to ``GlobalBatchNorm2d`` (except
those the model lists in ``REPLICATED_INPUT_NORMS``: BatchNorms whose input
is the same on every rank) and wraps it in ``DistributedDataParallel``,
which averages the gradients over the ranks. Under the mesh's model axis
each rank's gradient is its rows' part of its data group's
(``parallel/model_axis.py``): a communication hook then sums the gradients
over the world and divides them by the data axis's size, which sums them
over the model axis and averages them over the data axis. The buffers are
not broadcast from rank 0 before each forward: the global statistics leave
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
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from omnifusion_torch.parallel.mesh import data_world, model_world
from omnifusion_torch.parallel.sync_bn import convert_global_batchnorm


def _sum_over_model_axis(n_data, bucket):
    """DDP's communication hook under a model axis: the bucket (a
    ``dist.GradBucket``) summed over the world, divided by ``n_data``. No
    annotations: DDP checks them, and this module's are strings."""
    fut = dist.all_reduce(bucket.buffer().div_(n_data), async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


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
    ddp = DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None, **no_sync,
    )
    if model_world() > 1:
        ddp.register_comm_hook(data_world(), _sum_over_model_axis)
    return ddp


def unwrap(model: nn.Module) -> nn.Module:
    """The bare module of a DDP-wrapped model; any other model as it is."""
    return model.module if isinstance(model, DistributedDataParallel) else model
