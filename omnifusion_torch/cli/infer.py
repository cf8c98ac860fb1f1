"""Ground-truth-free inference: panoramas in, depth maps out.

    python -m omnifusion_torch.cli.infer --input pano.png --checkpoint ckpt/best.pt
    python -m omnifusion_torch.cli.infer --input panos/ --model iterative \
        --iter 2 --checkpoint upstream.pth --save_ply
    python -m omnifusion_torch.cli.infer --input 'panos/*.npy' --seed 0 --batch 4
    python -m omnifusion_torch.cli.infer --input panos/ --bf16 --merge_dtype f16

The port's counterpart of ``omnifusion_tpu/cli/infer.py``, with the flags of
``cli/common.py``. It builds the model once (``--model oneshot``, or
``iterative`` with ``--iter`` passes), loads ``--checkpoint`` (this port's
checkpoint or state dict, or an upstream ``.pth``) or fills seeded weights,
and answers batches of panoramas: a file, a directory or a glob of images
(read as the datasets read RGB: cv2's BGR order kept end to end,
INTER_AREA resize to the ERP resolution, [0, 1]) or of ``.npy`` ERP arrays
(H, W, 3) f32 in [0, 1] at the ``--erp_size`` resolution, in the same
channel order. Each input gives ``<save_path>/<stem>_depth.npy``, (H, W) f32
metres (the iterative model's last pass), a colorized ``<stem>_depth.png``
where cv2 is importable and, with ``--save_ply``, a point cloud
``<stem>.ply``. The one-shot model always merges confidence-weighted, the
iterative one only with ``--confidence``. ``--bf16`` runs the trunk in bf16;
with ``--merge_dtype f16`` that is the JAX package's serving recipe.

Runs on the CUDA card unless ``--device`` names another device.

``--mesh`` (cli/common.py) serves on a (data, model) mesh: each data group
answers its contiguous slice of every batch of ``--batch`` panoramas (the
last batch's slices may differ by one), its model ranks each a chunk of
the slice's patches, and model rank 0 of the group writes those files,
under the names one process gives them, each once.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from omnifusion_torch import parallel
from omnifusion_torch.cli import common
from omnifusion_torch.cli.common import add_common_args, load_weights, run_on_mesh, uses_confidence

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
_INPUT_EXTS = _IMAGE_EXTS + (".npy",)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OmniFusion depth inference (PyTorch)")
    add_common_args(parser, train=False)
    parser.add_argument("--input", required=True,
                        help="panorama (image or .npy), directory, or glob")
    return parser


def build_model(args) -> torch.nn.Module:
    """The eval-mode model the flags describe, with its weights."""
    return load_weights(args, common.build_model(args)).eval()


def list_inputs(inp: str) -> list[str]:
    if os.path.isdir(inp):
        paths = [os.path.join(inp, f) for f in sorted(os.listdir(inp))
                 if f.lower().endswith(_INPUT_EXTS)]
    elif os.path.isfile(inp):
        paths = [inp]
    else:
        paths = [p for p in sorted(glob.glob(inp))
                 if os.path.isfile(p) and p.lower().endswith(_INPUT_EXTS)]
    if not paths:
        raise FileNotFoundError(f"no input panoramas match {inp!r}")
    return paths


def output_stems(paths: list[str], save_path: str) -> list[str]:
    """Collision-safe output stems: basename, disambiguated with a counter
    when a glob matches duplicate basenames in different directories."""
    stems, used = [], {}
    for p in paths:
        base = os.path.splitext(os.path.basename(p))[0]
        n = used.get(base, 0)
        used[base] = n + 1
        stems.append(os.path.join(save_path, base if n == 0 else f"{base}_{n}"))
    return stems


def read_panorama(path: str, h: int, w: int) -> np.ndarray:
    """(H, W, 3) f32 in [0, 1]: an image through the datasets' RGB reader,
    or a ``.npy`` array, which must already be (H, W, 3)."""
    if path.lower().endswith(".npy"):
        frame = np.load(path).astype(np.float32, copy=False)
        if frame.shape != (h, w, 3):
            raise ValueError(f"{path}: expected an ({h}, {w}, 3) panorama, got {frame.shape}")
        return frame
    from omnifusion_torch.data.datasets import _read_rgb

    return _read_rgb(path, (w, h)).astype(np.float32) / 255.0


def run_infer(args) -> list[str]:
    """Answer every input panorama, on the mesh of ``--mesh``; returns the
    written depth paths, in input order."""
    return run_on_mesh(_infer, args)


def _infer(args) -> list[str]:
    from omnifusion_torch.utils import colorize, ply

    model = build_model(args)
    confidence = uses_confidence(args)
    device = next(model.parameters()).device
    h, w = model.spec.erp_h, model.spec.erp_w
    paths = list_inputs(args.input)
    stems = output_stems(paths, args.save_path)
    os.makedirs(args.save_path, exist_ok=True)
    try:
        import cv2
    except ImportError:
        cv2 = None
        print("## cv2 is not importable: the colorized depth PNGs are skipped")

    written = []
    rank, world = parallel.data_rank(), parallel.data_world()
    writes = parallel.model_rank() == 0
    for start in range(0, len(paths), args.batch):
        n = min(args.batch, len(paths) - start)
        lo, hi = start + n * rank // world, start + n * (rank + 1) // world  # this group's
        if lo == hi:
            continue
        chunk = paths[lo:hi]
        frames = [read_panorama(p, h, w) for p in chunk]
        with torch.inference_mode():
            rgb = torch.from_numpy(np.stack(frames)).to(device)
            out = model(rgb, confidence=confidence)
            depth = (out[-1] if isinstance(out, list) else out)[..., 0].cpu().numpy()
        if not writes:  # the group's model rank 0 writes its replica
            continue
        for stem, frame, d in zip(stems[lo:hi], frames, depth):
            np.save(stem + "_depth.npy", d)
            if cv2 is not None:
                cv2.imwrite(stem + "_depth.png", colorize(d, vmin=0)[..., ::-1])
            if args.save_ply:
                # BGR -> RGB for the red/green/blue labels
                xyz, colors = ply.depth_to_pointcloud(d, frame[..., ::-1])
                ply.write_ply(stem + ".ply", [xyz, colors], ["x", "y", "z", "red", "green", "blue"])
            written.append(stem + "_depth.npy")
            print(f"-> {stem}_depth.npy  [{d.min():.2f}, {d.max():.2f}] m")
    order = {stem + "_depth.npy": i for i, stem in enumerate(stems)}
    return sorted((p for part in parallel.all_gather_object(written) for p in part),
                  key=order.get)


def main(argv=None):
    run_infer(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
