"""Training entry point (parity: train_erp_depth.py / train_erp_depth_iterative.py).

    python -m omnifusion_torch.cli.train --dataset stanford --input_dir ... \
        --trainfile filenames/train_stanford2d3d.txt --testfile ... --batch 8
    python -m omnifusion_torch.cli.train --dataset synthetic --device cpu \
        --erp_size 64,128 --patchsize 32 --batch 2 --synthetic_size 4 --epochs 1
    python -m omnifusion_torch.cli.train --dataset synthetic --bf16 --merge_dtype f16
    python -m omnifusion_torch.cli.train --dataset synthetic --model iterative --iter 2

The port's counterpart of ``omnifusion_tpu/cli/train.py``, with the flags of
``cli/common.py``. Per epoch: train steps over shuffled batches of
``--trainfile`` (flip and quarter-width roll augmentations), a ``latest``
checkpoint of the full train state, and every ``--val_interval`` epochs (and
after the last) a validation pass over ``--testfile`` with the depth
metrics, logged to ``<save_path>/result_log.csv``; the state with the best
abs_rel is also saved as ``best``. ``--model iterative`` trains on the mean
loss over its passes and validates its last pass; it merges
confidence-weighted only with ``--confidence`` (the one-shot model always).

The weights start from ``--seed``. ``--checkpoint`` resumes from a
checkpoint this entry point wrote, or overlays an upstream ``.pth`` (or a
state dict of the port's model) onto them: every entry the file has, each of
the same shape (models/torch_import.py: merge_pretrained). ``--bf16``
trains the bf16 trunk on f32 parameters, with the BatchNorms normalizing and
the loss computed in f32; ``--merge_dtype`` sets the merge's source
precision. ``--tensorboard_path`` logs the loss and gradient norm every
``--visualize_interval`` steps, the validation metrics, and the first
validation batch's RGB, ground truth and predicted depth.
``--profile_dir`` writes a ``torch.profiler`` trace of steps 10-14 of epoch
0. Runs on the CUDA card unless ``--device`` names another device.

``--mesh`` (cli/common.py) trains data-parallel, one process per card,
each on its slice of every global batch of ``--batch``: the step is the
one-card step on the global batch (global BatchNorm statistics, BerHu's
global cutoff, DDP's average of the gradients), and the validation metrics
are the global batches'. Rank 0 prints and writes the log, the tensorboard
events, the trace and the checkpoints.

    torchrun --nproc_per_node 4 -m omnifusion_torch.cli.train --dataset ... --batch 8
    python -m omnifusion_torch.cli.train --dataset ... --batch 8 --mesh 4
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import time

import numpy as np
import torch

from omnifusion_torch import parallel
from omnifusion_torch.cli.common import (
    add_common_args,
    build_dataset,
    build_model,
    dump_run_config,
    entry_device,
    is_train_checkpoint,
    run_on_mesh,
    uses_confidence,
)
from omnifusion_torch.data import DataLoader
from omnifusion_torch.evaluation import MetricAccumulator
from omnifusion_torch.models import init_weights
from omnifusion_torch.models.torch_import import import_checkpoint, merge_pretrained
from omnifusion_torch.training import (
    CheckpointManager,
    create_train_state,
    eval_step,
    restore_state,
    train_step,
)
from omnifusion_torch.utils.profiling import Throughput, trace

METRICS = ("abs_rel", "sq_rel", "lin_rms_sq", "log_rms_sq", "d1", "d2", "d3")
PROFILE_STEPS = (10, 14)  # --profile_dir: the first and last traced step of epoch 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OmniFusion training (PyTorch)")
    return add_common_args(parser, train=True)


def restore_or_overlay(args, state) -> None:
    """--checkpoint: resume a train checkpoint, or overlay a state dict."""
    model = parallel.unwrap(state.model)
    device = next(model.parameters()).device
    ckpt = torch.load(args.checkpoint, map_location=device, weights_only=True)
    if is_train_checkpoint(ckpt):
        restore_state(state, ckpt)
    else:
        model.load_state_dict(merge_pretrained(model.state_dict(), import_checkpoint(ckpt)),
                              strict=True)


def log_images(writer, batch: dict, pred: torch.Tensor, epoch: int) -> None:
    """The first panorama of a validation batch (train_erp_depth.py:281-290)."""
    from omnifusion_torch.utils import colorize

    writer.add_image("RGB", batch["rgb"][0].cpu().numpy(), epoch, dataformats="HWC")
    writer.add_image("depth gt", colorize(batch["depth"][0].cpu().numpy()), epoch,
                     dataformats="HWC")
    writer.add_image("depth pred", colorize(pred[0].float().cpu().numpy()), epoch,
                     dataformats="HWC")


def run_training(args) -> dict:
    """Train as the flags say, on the mesh of ``--mesh``; returns the
    history (rank 0's): per-epoch mean train loss, the validation metrics,
    the best abs_rel and the update count. A data axis that does not divide
    ``--batch`` refuses."""
    return run_on_mesh(_train, args, divisible=True)


def _train(args) -> dict:
    device = entry_device(args)
    model = init_weights(build_model(args, device), args.seed)
    confidence = uses_confidence(args)
    spec = model.spec
    main_rank = parallel.rank() == 0
    log = print if main_rank else (lambda *a, **k: None)

    shard = dict(rank=parallel.rank(), world=parallel.world())
    train_loader = DataLoader(build_dataset(args, args.trainfile, train=True), args.batch,
                              shuffle=True, num_workers=args.workers, seed=args.seed, **shard)
    val_loader = DataLoader(build_dataset(args, args.testfile, train=False), args.batch,
                            num_workers=2, drop_last=False, **shard)
    steps_per_epoch = max(len(train_loader), 1)
    state = create_train_state(
        model, args.lr, args.weight_decay, args.t0, args.t_mult, steps_per_epoch
    )
    if parallel.is_distributed():
        state.model = parallel.wrap(model, device)
    dump_run_config(args)
    mgr = CheckpointManager(args.save_checkpoint or os.path.join(args.save_path, "ckpt"))
    if args.checkpoint:
        restore_or_overlay(args, state)

    n_params = sum(p.numel() for p in model.parameters())
    log(f"## model: {args.model}  params: {n_params / 1e6:.1f}M  patches: {spec.n_patches}  "
        f"device: {device}  bf16: {args.bf16}  merge: {args.merge_dtype}")
    log(f"## patch size: {(spec.patch_h, spec.patch_w)}  fov: {args.fov}  nrows: {args.nrows}")

    writer = None
    if args.tensorboard_path and main_rank:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(log_dir=args.tensorboard_path)

    csv_path = os.path.join(args.save_path, "result_log.csv")
    new_csv = not os.path.exists(csv_path)
    history: dict = {"train_loss": [], "val": []}
    best_abs_rel = float("inf")
    first_epoch = state.step // steps_per_epoch
    profile = args.profile_dir and main_rank
    with contextlib.ExitStack() as files, contextlib.ExitStack() as profiling:
        csvfile = files.enter_context(open(csv_path, "a", newline="")) if main_rank else None
        csvwriter = csv.writer(csvfile) if main_rank else None
        if new_csv and main_rank:
            csvwriter.writerow(["epoch", "loss", *METRICS])
        throughput = Throughput()
        for epoch in range(first_epoch, args.epochs):
            t0 = time.time()
            pending = []  # device scalars; read at the end of the epoch
            for it, batch in enumerate(train_loader.to_device(device)):
                if profile and epoch == 0 and it == PROFILE_STEPS[0]:
                    profiling.enter_context(trace(args.profile_dir))
                m = train_step(state, batch, confidence)
                pending.append((m["loss"], m["grad_norm"]))
                throughput.update(args.batch)
                if profile and epoch == 0 and it == PROFILE_STEPS[1]:
                    profiling.close()
                    print(f"## wrote profiler trace to {args.profile_dir}")
            profiling.close()  # an epoch 0 shorter than the window ends the trace
            losses = [float(loss) for loss, _ in pending]
            mean_loss = float(np.mean(losses)) if losses else float("nan")
            history["train_loss"].append(mean_loss)
            if writer and args.visualize_interval:
                for it in range(0, len(pending), args.visualize_interval):
                    step = epoch * steps_per_epoch + it + 1
                    writer.add_scalar("train/loss", losses[it], step)
                    writer.add_scalar("train/grad_norm", float(pending[it][1]), step)
            log(f"epoch {epoch}: loss {mean_loss:.4f}  ({time.time() - t0:.1f}s, "
                f"{len(losses)} steps, {throughput.per_sec:.1f} panos/s)")
            mgr.save(state, "latest")

            if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
                # the metrics are the global batches', the same on every rank
                acc = MetricAccumulator()
                for i, batch in enumerate(val_loader.to_device(device)):
                    m, n, pred = eval_step(state.model, batch, confidence)
                    acc.update({k: float(v) for k, v in m.items()}, float(n))
                    if writer and i == 0:
                        log_images(writer, batch, pred, epoch)
                avg = acc.averages()
                history["val"].append({"epoch": epoch, **avg})
                log("  val:", {k: round(v, 4) for k, v in avg.items()})
                if main_rank:
                    csvwriter.writerow([epoch, mean_loss] + [avg.get(k, "") for k in METRICS])
                    csvfile.flush()
                if writer:
                    for k, v in avg.items():
                        writer.add_scalar(f"val/{k}", v, epoch)
                if avg.get("abs_rel", float("inf")) < best_abs_rel:
                    best_abs_rel = avg["abs_rel"]
                    mgr.save(state, "best")  # "latest" holds this state already
    if writer:
        writer.close()
    history["best_abs_rel"] = best_abs_rel
    history["steps"] = state.step
    return history


def main(argv=None):
    run_training(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
