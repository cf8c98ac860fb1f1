"""Parallelism over ranks: one process per card, on a (data, model) mesh.

The port's counterpart of ``omnifusion_tpu/parallel/mesh.py``. The JAX
package runs one program over a (data, model) device mesh and lets GSPMD
make every reduction over the batch axis global. The port runs one process
per card under ``torch.distributed`` (``DistributedDataParallel``), so each
such reduction is an explicit collective: the BatchNorms' statistics
(``parallel/sync_bn.py``), BerHu's cutoff (``losses/direct.py``), the
segmentation loss's count of valid labels (``models/segmentation.py``), the
evaluation's median scaling (``training/trainer.py: eval_step``) and mIoU's
confusion counts (``cli/train_sem.py``).

Ranks sit on the mesh as ``jax.make_mesh((DATA, MODEL), ("data",
"model"))`` puts devices: rank = d * MODEL + m. The data axis splits the
batch: the MODEL ranks of data group d hold the same panoramas. The model
axis splits the folded B * P patch stack of those panoramas
(``parallel/model_axis.py``), so the reductions over the batch that the
model ranks hold replicas of (the losses' counts, the logged loss, eval's
gathers, mIoU's counts, the loader's slices) run over the data group
(``data_group``), and the BatchNorms', where every row is on one rank,
over the world.

``Mesh`` and ``parse_mesh`` follow the JAX ``build_mesh`` rules and
messages. The process group is the module's state: ``init_process_group``
brings it up with the rank's device and the mesh's subgroups,
``destroy`` takes it down, and the helpers below are the identity when no
group is up, so that every module that reduces over the batch runs
unchanged in one process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_device: Optional[torch.device] = None
# the mesh of the group that is up, and this rank's data and model
# subgroups (None: the axis spans the world, or there is no model axis)
_mesh: Optional["Mesh"] = None
_data_group: Optional[dist.ProcessGroup] = None
_model_group: Optional[dist.ProcessGroup] = None


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
    (None when that is 1); auto never picks a model axis. ``DATA[,MODEL]``:
    those counts, on DATA * MODEL devices, also where DATA does not divide
    ``batch``: the loader then gives every data group each batch whole
    (data/loader.py), and only the train entry point refuses
    (cli/train.py), as in the JAX package. A bad spec and more devices than
    ``n_cards`` raise SystemExit."""
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
    if n_data * n_model > n_cards:
        raise SystemExit(f"--mesh {spec!r} needs {n_data * n_model} devices but only "
                         f"{n_cards} are available (platform={platform!r})")
    return Mesh(n_data, n_model)


def init_process_group(rank: int, world: int, device, backend: Optional[str] = None,
                       store: Optional[dist.Store] = None, mesh: Optional[Mesh] = None) -> None:
    """Bring up the process group of this rank on ``device``: nccl on a
    CUDA device, gloo on the CPU, unless ``backend`` names one. Without a
    ``store`` the rendezvous reads the environment (torchrun's
    MASTER_ADDR, MASTER_PORT). ``mesh`` (default: every rank on the data
    axis) must hold ``world`` devices; with a model axis every rank builds
    the data and model subgroups, in one order."""
    global _device, _mesh, _data_group, _model_group
    mesh = mesh or Mesh(world)
    if mesh.data * mesh.model != world:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.data * mesh.model} ranks, not {world}")
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
    _device, _mesh = device, mesh
    if mesh.model > 1:
        d, m = mesh.data, mesh.model
        _model_group, _ = dist.new_subgroups_by_enumeration(
            [[i * m + j for j in range(m)] for i in range(d)])
        _data_group, _ = dist.new_subgroups_by_enumeration(
            [[i * m + j for i in range(d)] for j in range(m)])


def destroy() -> None:
    """Take the process group down, if one is up."""
    global _device, _mesh, _data_group, _model_group
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _device = _mesh = _data_group = _model_group = None


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def current_mesh() -> Optional[Mesh]:
    """The mesh of the group that is up; None with no group."""
    return _mesh if is_distributed() else None


def model_world() -> int:
    """Ranks on the model axis: those that share this rank's panoramas."""
    mesh = current_mesh()
    return mesh.model if mesh is not None else 1


def model_rank() -> int:
    return rank() % model_world()


def data_world() -> int:
    """Ranks on the data axis: the groups that split the batch."""
    return world() // model_world()


def data_rank() -> int:
    return rank() // model_world()


def data_group() -> Optional[dist.ProcessGroup]:
    """The ranks that hold this rank's model rank, one per data group: the
    group of the reductions over the batch that the model ranks hold
    replicas of. None (the world) without a model axis."""
    return _data_group if model_world() > 1 else None


def model_group() -> Optional[dist.ProcessGroup]:
    """The ranks that share this rank's panoramas; None without a model
    axis, where no collective over it runs."""
    return _model_group if model_world() > 1 else None


def device() -> Optional[torch.device]:
    """The device of this rank, while a group is up."""
    return _device if is_distributed() else None


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def all_reduce_(t: torch.Tensor, op: str = "sum",
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Reduce ``t`` in place over the ranks of ``group`` (default: the
    world; ``op``: sum or max); the identity when no group is up. Returns
    ``t``."""
    if is_distributed():
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=group)
    return t


def all_gather_cat(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) of ``group`` (default:
    the world) concatenated along dim 0, in rank order; ``t`` itself when no
    group is up."""
    if not is_distributed():
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order; ``[obj]`` when no group is up."""
    if not is_distributed():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def mean_over_ranks(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (default: the world;
    a new tensor)."""
    if not is_distributed():
        return t
    return all_reduce_(t.clone(), group=group) / dist.get_world_size(group)
