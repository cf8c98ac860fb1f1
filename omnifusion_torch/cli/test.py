"""Evaluation entry point (parity: test.py of the reference).

    python -m omnifusion_torch.cli.test --dataset stanford --input_dir ... \
        --testfile filenames/test_stanford2d3d.txt --model iterative --iter 2 \
        --checkpoint results/run/ckpt/best.pt

The port's counterpart of ``omnifusion_tpu/cli/test.py``: the median-scaled
metric suite (abs_rel, sq_rel, lin/log RMSE, delta<1.25^k) weighted by
valid-pixel count, over every test panorama (the last batch may be short);
the iterative model is scored on its last pass. The one-shot model always
merges confidence-weighted, the iterative one only with --confidence.
Every --visualize_interval batches it writes the first panorama's RGB,
depth, ground truth and error PNGs (where cv2 is importable) and, with
--save_ply, its point cloud. --checkpoint takes a checkpoint of this port
or a reference .pth (cli/common.py). Runs on the CUDA card unless
``--device`` names another device.

``--mesh`` (cli/common.py) evaluates on a (data, model) mesh: each data
group runs its slice of every batch (its model ranks each a chunk of the
slice's patches), and the metrics are those of the whole batch, gathered
over the data axis (the median scaling is the global batch's, as under the
JAX mesh); a last batch that the data axis cannot split evenly runs whole
on every data group, as the JAX package replicates it. Every rank holds
the same numbers, so the meters need no reduction. Rank 0 prints and
writes the dumps: the first panorama of a batch is its own.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from omnifusion_torch import parallel
from omnifusion_torch.cli.common import (
    add_common_args,
    build_dataset,
    dump_run_config,
    run_on_mesh,
    uses_confidence,
)
from omnifusion_torch.cli.infer import build_model

METRIC_LINES = (
    ("Avg. Abs. Rel. Error      ", "abs_rel", False),
    ("Avg. Sq. Rel. Error       ", "sq_rel", False),
    ("Avg. Lin. RMS Error       ", "lin_rms_sq", True),
    ("Avg. Log. RMS Error       ", "log_rms_sq", True),
    ("Inlier D1                 ", "d1", False),
    ("Inlier D2                 ", "d2", False),
    ("Inlier D3                 ", "d3", False),
)


def save_visuals(args, batch_idx: int, cv2, rgb, depth, mask, pred) -> None:
    """The PNGs (with ``cv2``, the module or None) and, with --save_ply, the
    PLY of one panorama (test.py:223-240): rgb (H, W, 3) in the loader's
    BGR order, depth, mask and pred (H, W, 1)."""
    from omnifusion_torch.utils import colorize, ply

    err = np.abs(depth - pred) * mask
    err[err < 0.1] = 0  # error-floor display rule (test.py:202-203)
    base = os.path.join(args.save_path, f"{batch_idx:04d}")
    if cv2 is not None:
        # the loader keeps cv2's BGR order (test.py:230-231 writes it
        # straight through); colorize gives RGB, imwrite expects BGR
        cv2.imwrite(base + "_rgb.png", (rgb * 255).astype(np.uint8))
        cv2.imwrite(base + "_pred.png", colorize(pred, vmin=0)[..., ::-1])
        cv2.imwrite(base + "_gt.png", colorize(depth, vmin=0)[..., ::-1])
        cv2.imwrite(base + "_error.png", colorize(err, vmin=0)[..., ::-1])
    if args.save_ply:
        # flip BGR->RGB to match the red/green/blue labels, as cli/infer.py
        xyz, colors = ply.depth_to_pointcloud(pred, rgb[..., ::-1])
        ply.write_ply(base + "_pred.ply", [xyz, colors], ["x", "y", "z", "red", "green", "blue"])


def run_eval(args) -> dict:
    """Score the model on the test split, on the mesh of ``--mesh``;
    returns the averaged metrics."""
    return run_on_mesh(_eval, args)


def _eval(args) -> dict:
    from omnifusion_torch.data import DataLoader
    from omnifusion_torch.evaluation import MetricAccumulator
    from omnifusion_torch.training import eval_step
    from omnifusion_torch.utils.profiling import Throughput

    model = build_model(args)
    device = next(model.parameters()).device
    ds = build_dataset(args, args.testfile, train=False)
    loader = DataLoader(ds, args.batch, shuffle=False, num_workers=2, drop_last=False,
                        rank=parallel.data_rank(), world=parallel.data_world())
    confidence = uses_confidence(args)
    dump_run_config(args)

    cv2 = None
    main_rank = parallel.rank() == 0
    if args.visualize_interval and main_rank:
        try:
            import cv2
        except ImportError:
            print("## cv2 is not importable: the PNG dumps are skipped")

    acc, throughput, n_panos = MetricAccumulator(), Throughput(), 0
    for batch_idx, batch in enumerate(loader.to_device(device)):
        metrics, n, pred = eval_step(model, batch, confidence)
        acc.update({k: float(v) for k, v in metrics.items()}, float(n))  # syncs
        if main_rank and args.visualize_interval and batch_idx % args.visualize_interval == 0:
            host = {k: batch[k][0].cpu().numpy() for k in ("rgb", "depth", "mask")}
            save_visuals(args, batch_idx, cv2, host["rgb"], host["depth"], host["mask"],
                         pred[0].float().cpu().numpy())
        panos = batch["rgb"].shape[0] * (parallel.data_world() if batch.sharded else 1)
        throughput.update(panos)
        n_panos += panos

    avg = acc.averages()
    if not main_rank:
        return avg
    print(f"## eval: {n_panos} panoramas on {device}, {throughput.per_sec:.1f} panos/s "
          "(after the first batch)")
    for label, key, root in METRIC_LINES:
        v = avg.get(key, float("nan"))
        print("{}: {:.4f}".format(label, np.sqrt(v) if root else v))
    return avg


def main(argv=None):
    parser = argparse.ArgumentParser(description="OmniFusion evaluation (PyTorch)")
    add_common_args(parser, train=False)
    run_eval(parser.parse_args(argv))


if __name__ == "__main__":
    main()
