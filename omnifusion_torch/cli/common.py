"""Shared CLI plumbing: the JAX package's flag surface.

The port's counterpart of ``omnifusion_tpu/cli/common.py``. Flag names
mirror train_erp_depth.py:31-68 / test.py:34-65 so existing configs
translate 1:1, and --patchsize is a proper "H,W" or "N" parser.

Left out, because they select XLA or TPU machinery the port does not have:
``--kernel_impl`` and ``--resize_impl`` (the port has one implementation of
each: its CUDA kernels, and their plain versions on the CPU). ``--remat``
rematerializes the encoder with ``torch.utils.checkpoint`` (``DepthTrunk``).
The port adds ``--device`` (default: the CUDA card;
``device.resolve_device``).

``--mesh`` (default ``auto``) puts the batch on ranks, one process per
card (``omnifusion_torch/parallel``), with the JAX package's rules
(``build_mesh``): ``auto`` takes every card, shrunk to the largest count
that divides ``--batch``; ``DATA`` takes that many, and where DATA does not
divide a batch every rank runs that batch whole (``cli/train.py`` alone
refuses such a ``--batch``); ``none``, or one card, runs in one process. The model axis (``DATA,MODEL`` with MODEL > 1) is not
ported and refuses. ``run_on_mesh`` runs an entry point's body on the
mesh: under torchrun in the ranks it started, with ``--mesh 1`` in this
process (a process group of one), else in ``DATA`` spawned processes, rank
r on ``cuda:r``. On the CPU (``--device cpu``) ``auto`` is one process and
``DATA`` that many gloo processes.

``--checkpoint`` takes a file: a checkpoint that ``cli/train.py`` wrote
(``<save_path>/ckpt/{latest,best}.pt``), a state dict of the port's model,
or an upstream ``.pth`` (models/torch_import.py). Without one the weights
come from ``--seed`` (``models.init_weights``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch

from omnifusion_torch import parallel
from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, init_weights
from omnifusion_torch.models.torch_import import import_checkpoint
from omnifusion_torch.parallel import launch
from omnifusion_torch.projection import ProjectionSpec

MERGE_DTYPES = {"f32": None, "f16": torch.float16, "bf16": torch.bfloat16}


def pair_arg(value: str) -> tuple[int, int]:
    parts = [p for p in value.replace("(", "").replace(")", "").split(",") if p.strip()]
    if len(parts) == 1:
        v = int(parts[0])
        return (v, v)
    if len(parts) == 2:
        return (int(parts[0]), int(parts[1]))
    raise argparse.ArgumentTypeError(f"expected 'N' or 'H,W', got {value!r}")


def add_common_args(parser: argparse.ArgumentParser, train: bool) -> argparse.ArgumentParser:
    parser.add_argument("--input_dir", default="./data/", help="dataset root path")
    parser.add_argument("--trainfile", default="./filenames/train.txt")
    parser.add_argument("--testfile", default="./filenames/test.txt")
    parser.add_argument(
        "--dataset", default="stanford", choices=["stanford", "matterport", "360d", "synthetic"]
    )
    parser.add_argument(
        "--synthetic_size", type=int, default=None,
        help="sample count for --dataset synthetic (default 32 train / 8 eval)",
    )
    parser.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    parser.add_argument("--fov", type=float, default=80.0)
    parser.add_argument("--nrows", type=int, default=4, choices=[3, 4, 5, 6])
    parser.add_argument(
        "--erp_size", type=pair_arg, default=None,
        help="ERP resolution (default 512,1024; 256,512 for --dataset 360d)",
    )
    parser.add_argument("--iter", dest="iters", type=int, default=2,
                        help="refinement passes of --model iterative")
    parser.add_argument("--confidence", action="store_true",
                        help="confidence-weighted merge for --model iterative "
                        "(the one-shot model always merges so)")
    parser.add_argument("--model", default="oneshot", choices=["oneshot", "iterative"])
    parser.add_argument("--batch", type=int, default=8 if train else 2)
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint file: this port's, or an upstream .pth")
    parser.add_argument("--save_path", default="./results/run")
    parser.add_argument("--seed", type=int, default=42,
                        help="data seed, and the weights' without --checkpoint")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 trunk on f32 parameters (BatchNorm and loss in f32)")
    parser.add_argument("--merge_dtype", default="f32", choices=sorted(MERGE_DTYPES),
                        help="precision of the confidence merge's source")
    parser.add_argument("--no_transformer", action="store_true",
                        help="legacy variant without global patch fusion (network_360d.py)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize the encoder: its activations are computed again "
                        "in the backward, trading FLOPs for memory")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    parser.add_argument(
        "--mesh",
        default="auto",
        help="device mesh as 'DATA[,MODEL]' counts, 'auto' (all local devices "
        "on the data axis — the reference's default nn.DataParallel behavior, "
        "train_erp_depth.py:143), or 'none' (single device, no mesh)",
    )
    parser.add_argument("--visualize_interval", type=int, default=20)
    if train:
        parser.add_argument("--epochs", type=int, default=100)
        parser.add_argument("--lr", type=float, default=1e-4)
        parser.add_argument("--weight_decay", type=float, default=0.01)
        parser.add_argument("--t0", type=int, default=5, help="cosine warm restart T_0")
        parser.add_argument("--t_mult", type=int, default=2)
        parser.add_argument("--val_interval", type=int, default=2,
                            help="epochs between validations")
        parser.add_argument("--save_checkpoint", default=None,
                            help="checkpoint dir (default save_path/ckpt)")
        parser.add_argument("--tensorboard_path", default=None)
        parser.add_argument("--workers", type=int, default=8)
        parser.add_argument("--profile_dir", default=None,
                            help="write a torch.profiler trace of steps 10-14 of epoch 0")
    else:
        parser.add_argument("--save_ply", action="store_true")
    return parser


def resolve_erp_size(args) -> tuple[int, int]:
    if args.erp_size is None:
        args.erp_size = (256, 512) if args.dataset == "360d" else (512, 1024)
    return args.erp_size


def uses_confidence(args) -> bool:
    """Whether the model merges confidence-weighted: the one-shot model
    always (spherical_model.py:238), the iterative one with --confidence."""
    return args.model == "oneshot" or args.confidence


def build_mesh(args) -> Optional[parallel.Mesh]:
    """The mesh of ``--mesh``, or None for one process (parallel.parse_mesh).
    Under torchrun the world size is the device count: ``auto`` takes it
    and an explicit data count must equal it."""
    spec = getattr(args, "mesh", "auto") or "auto"
    env = launch.torchrun_env()
    if env is not None:
        n_cards, platform = env[1], "torchrun"
    elif args.device is not None and torch.device(args.device).type == "cpu":
        # processes on the CPU: as many as asked, and one for auto
        n_cards, platform = (1 if spec == "auto" else os.cpu_count() or 1), "cpu"
    else:
        n_cards, platform = torch.cuda.device_count(), "cuda"
    mesh = parallel.parse_mesh(spec, int(getattr(args, "batch", 0) or 0), n_cards, platform)
    if env is not None and mesh is not None and mesh.data != env[1]:
        raise SystemExit(f"--mesh {spec!r}: under torchrun the data axis is the world "
                         f"size, {env[1]}")
    return mesh


def entry_device(args) -> torch.device:
    """The device of this process: its rank's under a mesh, else
    ``--device`` or the card."""
    return parallel.device() or resolve_device(args.device)


def _rank_device(device: Optional[str], local_rank: int) -> str:
    on_cpu = device is not None and torch.device(device).type == "cpu"
    return "cpu" if on_cpu else f"cuda:{local_rank}"


def run_on_mesh(body, args, divisible: bool = False):
    """``body(args)`` on the mesh of ``--mesh``; returns rank 0's result.
    ``body`` is a module-level function (the spawned ranks import it).
    ``divisible``: refuse a data axis that does not divide ``--batch`` (the
    train entry point's rule, omnifusion_tpu/cli/train.py:101-103); the
    other entry points give every rank such a batch whole."""
    mesh = build_mesh(args)
    if divisible and mesh is not None and args.batch % mesh.data:
        raise SystemExit(f"--batch {args.batch} not divisible by data axis {mesh.data}")
    if mesh is None or parallel.is_distributed():
        return body(args)
    print(f"## mesh: {mesh.shape}")
    env = launch.torchrun_env()
    if env is None and mesh.data > 1:
        return launch.spawn(body, mesh.data, (args,),
                            lambda r: _rank_device(args.device, r))[0]
    rank, world, local = env if env is not None else (0, 1, 0)
    device = _rank_device(args.device, local)
    store = None if env is not None else torch.distributed.HashStore()
    parallel.init_process_group(rank, world, device, store=store)
    try:
        return body(args)
    finally:
        parallel.destroy()


def build_model(args, device=None):
    """The model the flags describe, on ``device`` (default: ``--device``,
    else the card), with PyTorch's default init; ``load_weights`` fills it."""
    resolve_erp_size(args)
    device = entry_device(args) if device is None else device
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (args.fov, args.fov), args.nrows)
    kw = dict(
        dtype=torch.bfloat16 if args.bf16 else None,
        merge_dtype=MERGE_DTYPES[args.merge_dtype],
        use_transformer=not args.no_transformer,
        device=device,
        remat=args.remat,
    )
    if args.model == "iterative":
        return SphericalFusionIterative(spec, num_iters=args.iters, **kw)
    return SphericalFusion(spec, **kw)


def is_train_checkpoint(ckpt) -> bool:
    """Whether ``ckpt`` (a loaded file) is a checkpoint of the full train
    state, as ``training.CheckpointManager`` writes it."""
    return isinstance(ckpt, dict) and {"model", "optimizer", "step"} <= set(ckpt)


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The model state dict in a checkpoint file: a train checkpoint's
    model, or a state dict (the port's, or an upstream one, imported)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"] if is_train_checkpoint(ckpt) else import_checkpoint(ckpt)


def load_weights(args, model: torch.nn.Module) -> torch.nn.Module:
    """Fill ``model`` from ``--checkpoint`` (strict), or from ``--seed``."""
    if args.checkpoint:
        model.load_state_dict(read_state_dict(args.checkpoint), strict=True)
    else:
        print("## no checkpoint given: evaluating a randomly initialized model")
        init_weights(model, args.seed)
    return model


def build_dataset(args, split_file: str, train: bool):
    from omnifusion_torch.data import make_dataset

    resolve_erp_size(args)
    if args.dataset == "synthetic":
        return make_dataset(
            "synthetic",
            size=args.synthetic_size or (32 if train else 8),
            pano_h=args.erp_size[0],
            pano_w=args.erp_size[1],
            seed=args.seed,
        )
    # each rank draws its own augmentations
    return make_dataset(args.dataset, args.input_dir, split_file, rotate=train, flip=train,
                        seed=args.seed + parallel.rank())


def dump_run_config(args) -> None:
    """Provenance: the exact run configuration in the results dir (the
    reference copies the script itself, train_erp_depth.py:87-88). Rank
    0's alone under a mesh."""
    if parallel.rank() != 0:
        return
    os.makedirs(args.save_path, exist_ok=True)
    payload = {
        "argv": sys.argv,
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "args": {k: v if isinstance(v, (int, float, str, bool, type(None), list, tuple))
                 else repr(v) for k, v in vars(args).items()},
    }
    with open(os.path.join(args.save_path, "run_config.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)
