"""Training entry point for the one-shot and the iterative model.

    python -m omnifusion_torch.cli.train --dataset synthetic --epochs 2 --batch 8
    python -m omnifusion_torch.cli.train --dataset synthetic --device cpu \
        --erp_size 64,128 --patchsize 32 --batch 2 --synthetic_size 4 --epochs 1
    python -m omnifusion_torch.cli.train --dataset synthetic --model iterative --iter 2

The port's counterpart of ``omnifusion_tpu/cli/train.py`` with the flags of
``omnifusion_tpu/cli/common.py`` that this path uses. Per epoch: train steps
over shuffled batches, a ``latest`` checkpoint of the full train state, and
every ``--val_interval`` epochs (and after the last) a validation pass with
the depth metrics, logged to ``<save_path>/result_log.csv``; the state with
the best abs_rel is also saved as ``best``. ``--model iterative`` trains on
the mean loss over its passes and validates its last pass; it merges
confidence-weighted only with ``--confidence`` (the one-shot model always).
``--checkpoint`` resumes from a checkpoint file this entry point wrote.

Only ``--dataset synthetic`` is ported; the weights start from
``--seed``. Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np

from omnifusion_torch.cli.infer import (
    MERGE_DTYPES,
    add_model_args,
    make_model,
    pair_arg,
    uses_confidence,
)
from omnifusion_torch.data import DataLoader, SyntheticDataset
from omnifusion_torch.device import resolve_device
from omnifusion_torch.evaluation import MetricAccumulator
from omnifusion_torch.models import init_weights
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import (
    CheckpointManager,
    create_train_state,
    eval_step,
    restore_file,
    train_step,
)
from omnifusion_torch.utils.profiling import Throughput

METRICS = ("abs_rel", "sq_rel", "lin_rms_sq", "log_rms_sq", "d1", "d2", "d3")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OmniFusion training (PyTorch)")
    parser.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    add_model_args(parser)
    parser.add_argument(
        "--synthetic_size", type=int, default=None,
        help="sample count for --dataset synthetic (default 32 train / 8 eval)",
    )
    parser.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    parser.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    parser.add_argument("--fov", type=float, default=80.0)
    parser.add_argument("--nrows", type=int, default=4, choices=[3, 4, 5, 6])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--checkpoint", default=None, help="checkpoint file to resume from")
    parser.add_argument("--save_path", default="./results/run")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--merge_dtype", default="f32", choices=sorted(MERGE_DTYPES))
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--t0", type=int, default=5, help="cosine warm restart T_0")
    parser.add_argument("--t_mult", type=int, default=2)
    parser.add_argument("--val_interval", type=int, default=2, help="epochs between validations")
    parser.add_argument("--save_checkpoint", default=None, help="checkpoint dir (default save_path/ckpt)")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    return parser


def run_training(args) -> dict:
    """Train as the flags say; returns the history: per-epoch mean train
    loss, the validation metrics, the best abs_rel and the update count."""
    device = resolve_device(args.device)
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (args.fov, args.fov), args.nrows)
    model, confidence = make_model(args, spec, device), uses_confidence(args)
    init_weights(model, args.seed)

    def dataset(train: bool):
        size = args.synthetic_size or (32 if train else 8)
        return SyntheticDataset(size, spec.erp_h, spec.erp_w, seed=args.seed)

    train_loader = DataLoader(
        dataset(True), args.batch, shuffle=True, num_workers=args.workers, seed=args.seed
    )
    val_loader = DataLoader(dataset(False), args.batch, num_workers=2, drop_last=False)
    steps_per_epoch = max(len(train_loader), 1)
    state = create_train_state(
        model, args.lr, args.weight_decay, args.t0, args.t_mult, steps_per_epoch
    )
    mgr = CheckpointManager(args.save_checkpoint or os.path.join(args.save_path, "ckpt"))
    if args.checkpoint:
        restore_file(state, args.checkpoint)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"## model: {args.model}  params: {n_params / 1e6:.1f}M  patches: {spec.n_patches}  "
          f"device: {device}")

    os.makedirs(args.save_path, exist_ok=True)
    csv_path = os.path.join(args.save_path, "result_log.csv")
    new_csv = not os.path.exists(csv_path)
    history: dict = {"train_loss": [], "val": []}
    best_abs_rel = float("inf")
    first_epoch = state.step // steps_per_epoch
    with open(csv_path, "a", newline="") as csvfile:
        csvwriter = csv.writer(csvfile)
        if new_csv:
            csvwriter.writerow(["epoch", "loss", *METRICS])
        throughput = Throughput()
        for epoch in range(first_epoch, args.epochs):
            t0 = time.time()
            pending = []  # device scalars; read at the end of the epoch
            for batch in train_loader.to_device(device):
                pending.append(train_step(state, batch, confidence)["loss"])
                throughput.update(args.batch)
            losses = [float(v) for v in pending]
            mean_loss = float(np.mean(losses)) if losses else float("nan")
            history["train_loss"].append(mean_loss)
            seconds = time.time() - t0
            print(f"epoch {epoch}: loss {mean_loss:.4f}  ({seconds:.1f}s, {len(losses)} steps, "
                  f"{throughput.per_sec:.1f} panos/s)")
            mgr.save(state, "latest")

            if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
                acc = MetricAccumulator()
                for batch in val_loader.to_device(device):
                    m, n, _ = eval_step(model, batch, confidence)
                    acc.update({k: float(v) for k, v in m.items()}, float(n))
                avg = acc.averages()
                history["val"].append({"epoch": epoch, **avg})
                print("  val:", {k: round(v, 4) for k, v in avg.items()})
                csvwriter.writerow([epoch, mean_loss] + [avg.get(k, "") for k in METRICS])
                csvfile.flush()
                if avg.get("abs_rel", float("inf")) < best_abs_rel:
                    best_abs_rel = avg["abs_rel"]
                    mgr.save(state, "best")  # "latest" holds this state already
    history["best_abs_rel"] = best_abs_rel
    history["steps"] = state.step
    return history


def main(argv=None):
    run_training(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
