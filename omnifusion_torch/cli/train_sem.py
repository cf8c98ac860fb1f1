"""Semantic-segmentation training entry point.

    python -m omnifusion_torch.cli.train_sem --dataset stanford --input_dir ... \
        --trainfile lists/train.txt --testfile lists/test.txt --num_classes 13 --epochs 60
    python -m omnifusion_torch.cli.train_sem --dataset synthetic --device cpu \
        --erp_size 64,128 --patchsize 32 --batch 2 --epochs 1

The port's counterpart of ``omnifusion_tpu/cli/train_sem.py``, with the
flags of ``cli/common.py`` plus ``--num_classes``: the geometry-aware trunk
with a class-logit head (``models.SphericalFusionSeg``), cross-entropy with
ignore index -1, and per epoch a ``latest`` checkpoint of the full train
state and a validation pass (the argmax of the logits, eval mode) scored by
mIoU (``utils.iou``); the state with the best mIoU is also saved as
``best``. ``--dataset synthetic`` trains on 32 procedural panoramas and
validates on 8 (``SyntheticSemanticDataset``, seeds ``--seed`` and
``--seed`` + 1); any other ``--dataset`` reads ``SemanticDataset`` from
``--trainfile`` (flip and quarter-width roll) and ``--testfile``. The
weights start from ``--seed``. ``--bf16`` trains the bf16 trunk on f32
parameters; the logits and the merge stay f32. As in the JAX entry point,
the depth CLIs' ``--model``, ``--checkpoint``, ``--merge_dtype``,
``--synthetic_size``, ``--val_interval`` and logging flags are not read
here. ``--profile_dir`` writes a ``torch.profiler`` trace (``trace.json``)
of steps 10-14 of epoch 0 with the program's spans in it, as cli/train.py
does. Runs on the CUDA card unless ``--device`` names another device.

``--mesh`` (cli/common.py) trains on a (data, model) mesh as cli/train.py
does: the cross-entropy's mean is over the global batch's valid labels,
and the validation's confusion counts are summed over the data axis (a
batch that the data axis cannot split evenly runs whole on every data group
and counts once). Rank 0 prints and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from omnifusion_torch import parallel
from omnifusion_torch.cli.common import (
    PROFILE_STEPS,
    add_common_args,
    dump_run_config,
    entry_device,
    profile_steps,
    resolve_erp_size,
    run_on_mesh,
)
from omnifusion_torch.data import DataLoader, SemanticDataset, SyntheticSemanticDataset
from omnifusion_torch.models import SphericalFusionSeg, init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import CheckpointManager, create_train_state, train_step_sem
from omnifusion_torch.utils import confusion_matrix, mean_iou


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OmniFusion semantic segmentation (PyTorch)")
    add_common_args(parser, train=True)
    parser.add_argument("--num_classes", type=int, default=13)
    return parser


def predict(model: SphericalFusionSeg, rgb: torch.Tensor) -> torch.Tensor:
    """Eval-mode class map (B, H, W) of a batch of panoramas."""
    model.eval()
    with torch.inference_mode():
        return model(rgb).argmax(-1)


def run_training_sem(args) -> dict:
    """Train as the flags say, on the mesh of ``--mesh``; returns the
    history (rank 0's): per-epoch mean train loss and validation mIoU, and
    the best mIoU."""
    return run_on_mesh(_train_sem, args)


def _train_sem(args) -> dict:
    device = entry_device(args)
    h, w = resolve_erp_size(args)
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (args.fov, args.fov), args.nrows)
    model = init_weights(SphericalFusionSeg(
        spec, num_classes=args.num_classes, use_transformer=not args.no_transformer,
        dtype=torch.bfloat16 if args.bf16 else None, device=device, remat=args.remat,
    ), args.seed)

    if args.dataset == "synthetic":
        train_ds = SyntheticSemanticDataset(32, h, w, args.num_classes, args.seed)
        val_ds = SyntheticSemanticDataset(8, h, w, args.num_classes, args.seed + 1)
    else:
        train_ds = SemanticDataset(args.input_dir, args.trainfile, rotate=True, flip=True,
                                   seed=args.seed + parallel.data_rank())
        val_ds = SemanticDataset(args.input_dir, args.testfile)
    shard = dict(rank=parallel.data_rank(), world=parallel.data_world())
    train_loader = DataLoader(train_ds, args.batch, shuffle=True, num_workers=args.workers,
                              seed=args.seed, **shard)
    val_loader = DataLoader(val_ds, args.batch, num_workers=2, drop_last=False, **shard)
    state = create_train_state(model, args.lr, args.weight_decay, args.t0, args.t_mult,
                               steps_per_epoch=max(len(train_loader), 1))
    if parallel.is_distributed():
        state.model = parallel.wrap(model, device)
    dump_run_config(args)
    mgr = CheckpointManager(args.save_checkpoint or os.path.join(args.save_path, "ckpt"))
    log = print if parallel.rank() == 0 else (lambda *a, **k: None)
    log(f"## segmentation: {args.num_classes} classes  params: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M  patches: {spec.n_patches}  "
          f"device: {device}  bf16: {args.bf16}")

    history: dict = {"train_loss": [], "miou": []}
    best_miou = 0.0
    profile_dir = args.profile_dir if parallel.rank() == 0 else None
    for epoch in range(args.epochs):
        t0 = time.time()
        batches = profile_steps(train_loader.to_device(device),
                                profile_dir if epoch == 0 else None, PROFILE_STEPS)
        pending = [train_step_sem(state, batch)["loss"]  # device scalars, read once
                   for batch in batches]
        mean_loss = float(np.mean([float(x) for x in pending])) if pending else float("nan")
        history["train_loss"].append(mean_loss)
        mgr.save(state, "latest")

        # confusion counts of the batches split over the data axis (summed
        # over it) and of those every data group runs whole
        nc = args.num_classes
        sliced, whole = np.zeros((nc, nc), np.int64), np.zeros((nc, nc), np.int64)
        for batch in val_loader.to_device(device):
            cm = confusion_matrix(predict(model, batch["rgb"]).cpu().numpy(),
                                  batch["labels"].cpu().numpy(), nc)
            if batch.sharded:
                sliced += cm
            else:
                whole += cm
        sliced = parallel.all_reduce_(torch.from_numpy(sliced).to(device),
                                      group=parallel.data_group()).cpu().numpy()
        miou, _ = mean_iou(sliced + whole)
        history["miou"].append(miou)
        log(f"epoch {epoch}: loss {mean_loss:.4f}  mIoU {miou:.4f}  ({time.time() - t0:.1f}s)")
        if miou > best_miou:
            best_miou = miou
            mgr.save(state, "best")  # "latest" holds this state already
    history["best_miou"] = best_miou
    return history


def main(argv=None):
    return run_training_sem(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
