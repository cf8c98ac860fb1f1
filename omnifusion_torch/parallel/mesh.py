"""Data parallelism over ranks: one process per card.

The port's counterpart of ``omnifusion_tpu/parallel/mesh.py``. The JAX
package runs one program over a (data, model) device mesh and lets GSPMD
make every reduction over the batch axis global. The port runs one process
per card under ``torch.distributed`` (``DistributedDataParallel``), so each
such reduction is an explicit collective: the BatchNorms' statistics
(``parallel/sync_bn.py``), BerHu's cutoff (``losses/direct.py``), the
segmentation loss's count of valid labels (``models/segmentation.py``), the
evaluation's median scaling (``training/trainer.py: eval_step``) and mIoU's
confusion counts (``cli/train_sem.py``). Only the data axis is ported: the
model axis, which shards the patch axis and gives the same numbers, is not.

``Mesh`` and ``parse_mesh`` follow the JAX ``build_mesh`` rules and
messages. The process group is the module's state: ``init_process_group``
brings it up with the rank's device, ``destroy`` takes it down, and the
helpers below are the identity when no group is up, so that every module
that reduces over the batch runs unchanged in one process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_device: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def parse_mesh(spec: Optional[str], batch: int, n_cards: int,
               platform: str = "cuda") -> Optional[Mesh]:
    """The mesh of a ``--mesh`` value, or None for one device.

    ``none``, or ``auto`` on one device: None. ``auto`` on several: the data
    axis is the largest divisor of ``batch`` that is at most ``n_cards``
    (None when that is 1). ``DATA[,MODEL]``: those counts. A bad spec, a
    model axis above 1 (not ported), more devices than ``n_cards`` and a
    batch that the data axis does not divide raise SystemExit."""
    spec = spec or "auto"
    if spec == "none" or (spec == "auto" and n_cards == 1):
        return None
    if spec == "auto":
        n_data = max((d for d in range(1, n_cards + 1) if batch % d == 0), default=1)
        if n_data <= 1:
            return None
        if n_data < n_cards:
            print(f"## mesh auto: data={n_data} of {n_cards} devices "
                  f"(largest divisor of batch {batch}); pass --mesh to override")
        return Mesh(n_data)
    try:
        parts = [int(p) for p in spec.split(",") if p.strip()]
        if not 1 <= len(parts) <= 2 or any(p < 1 for p in parts):
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--mesh: expected 'auto', 'none', or 'DATA[,MODEL]' counts, got {spec!r}"
        )
    n_data, n_model = parts[0], (parts[1] if len(parts) > 1 else 1)
    if n_model > 1:
        raise SystemExit(f"--mesh {spec!r}: the model axis shards the patch axis, and the "
                         "patch axis is not ported yet (see ROADMAP)")
    if n_data > n_cards:
        raise SystemExit(f"--mesh {spec!r} needs {n_data} devices but only {n_cards} are "
                         f"available (platform={platform!r})")
    if batch % n_data != 0:
        raise SystemExit(f"--batch {batch} not divisible by data axis {n_data}")
    return Mesh(n_data)


def init_process_group(rank: int, world: int, device, backend: Optional[str] = None,
                       store: Optional[dist.Store] = None) -> None:
    """Bring up the process group of this rank on ``device``: nccl on a
    CUDA device, gloo on the CPU, unless ``backend`` names one. Without a
    ``store`` the rendezvous reads the environment (torchrun's
    MASTER_ADDR, MASTER_PORT)."""
    global _device
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if store is None:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    _device = device


def destroy() -> None:
    """Take the process group down, if one is up."""
    global _device
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def device() -> Optional[torch.device]:
    """The device of this rank, while a group is up."""
    return _device if is_distributed() else None


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over the ranks (``op``: sum or max); the
    identity when no group is up. Returns ``t``."""
    if is_distributed():
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return t


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim
    0, in rank order; ``t`` itself when no group is up."""
    if not is_distributed():
        return t
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order; ``[obj]`` when no group is up."""
    if not is_distributed():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a new tensor)."""
    return all_reduce_(t.clone()) / world() if is_distributed() else t
