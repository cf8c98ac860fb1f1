"""Ground-truth-free inference: panoramas in, depth maps out.

    python -m omnifusion_torch.cli.infer --input panos/ --checkpoint model.pt
    python -m omnifusion_torch.cli.infer --input 'panos/*.npy' --seed 0 --batch 4
    python -m omnifusion_torch.cli.infer --input panos/ --bf16 --merge_dtype f16
    python -m omnifusion_torch.cli.infer --input panos/ --model iterative --iter 2

The port's counterpart of ``omnifusion_tpu/cli/infer.py``. It builds the
model once (``--model oneshot``, or ``iterative`` with ``--iter`` passes),
loads a ``.pt`` state dict (the port's keys, e.g. from
``models.convert.state_dict_from_jax``) or fills seeded weights, and
answers batches of panoramas. Each input is a ``.npy`` ERP image (H, W, 3)
f32 in [0, 1] at the ``--erp_size`` resolution; each output is
``<save_path>/<stem>_depth.npy``, (H, W) f32 metres: the iterative model's
last pass. The one-shot model always merges confidence-weighted, the
iterative one only with ``--confidence``, as in the JAX package. ``--bf16``
runs the trunk in bf16 (``dtype=torch.bfloat16``); with ``--merge_dtype
f16`` that is the JAX package's serving recipe.

Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from omnifusion_torch.device import resolve_device
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, init_weights
from omnifusion_torch.projection import ProjectionSpec

MERGE_DTYPES = {"f32": None, "f16": torch.float16, "bf16": torch.bfloat16}


def pair_arg(value: str) -> tuple[int, int]:
    parts = [p for p in value.replace("(", "").replace(")", "").split(",") if p.strip()]
    if len(parts) == 1:
        return (int(parts[0]), int(parts[0]))
    if len(parts) == 2:
        return (int(parts[0]), int(parts[1]))
    raise argparse.ArgumentTypeError(f"expected 'N' or 'H,W', got {value!r}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="OmniFusion depth inference (PyTorch)")
    parser.add_argument("--input", required=True, help=".npy panorama, directory, or glob")
    add_model_args(parser)
    parser.add_argument("--save_path", default="./results/run")
    parser.add_argument("--checkpoint", default=None, help=".pt state dict (else seeded weights)")
    parser.add_argument("--seed", type=int, default=42, help="weight seed without --checkpoint")
    parser.add_argument("--erp_size", type=pair_arg, default=(512, 1024))
    parser.add_argument("--patchsize", type=pair_arg, default=(128, 128))
    parser.add_argument("--fov", type=float, default=80.0)
    parser.add_argument("--nrows", type=int, default=4, choices=[3, 4, 5, 6])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    parser.add_argument("--bf16", action="store_true", help="bf16 trunk (f32 parameters)")
    parser.add_argument("--merge_dtype", default="f32", choices=sorted(MERGE_DTYPES))
    return parser


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The model flags that ``cli/infer.py`` and ``cli/train.py`` share
    (``omnifusion_tpu/cli/common.py:61-63``)."""
    parser.add_argument("--model", default="oneshot", choices=["oneshot", "iterative"])
    parser.add_argument("--iter", dest="iters", type=int, default=2,
                        help="refinement passes of --model iterative")
    parser.add_argument("--confidence", action="store_true",
                        help="confidence-weighted merge for --model iterative "
                        "(the one-shot model always merges so)")


def make_model(args, spec: ProjectionSpec, device, dtype=None):
    """The model ``--model`` names, with PyTorch's default init."""
    kw = dict(dtype=dtype, merge_dtype=MERGE_DTYPES[args.merge_dtype], device=device)
    if args.model == "iterative":
        return SphericalFusionIterative(spec, num_iters=args.iters, **kw)
    return SphericalFusion(spec, **kw)


def uses_confidence(args) -> bool:
    """Whether the model merges confidence-weighted."""
    return args.model == "oneshot" or args.confidence


def list_inputs(inp: str) -> list[str]:
    if os.path.isdir(inp):
        paths = [os.path.join(inp, f) for f in sorted(os.listdir(inp)) if f.endswith(".npy")]
    elif os.path.isfile(inp):
        paths = [inp]
    else:
        paths = [p for p in sorted(glob.glob(inp)) if os.path.isfile(p) and p.endswith(".npy")]
    if not paths:
        raise FileNotFoundError(f"no .npy panoramas match {inp!r}")
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


def build_model(args):
    """The eval-mode model the flags describe, with its weights."""
    device = resolve_device(args.device)
    spec = ProjectionSpec.create(args.erp_size, args.patchsize, (args.fov, args.fov), args.nrows)
    model = make_model(args, spec, device, torch.bfloat16 if args.bf16 else None)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location=device, weights_only=True)
        model.load_state_dict(sd, strict=True)
    else:
        init_weights(model, args.seed)
    return model.eval()


def run_infer(args) -> list[str]:
    """Answer every input panorama; returns the written depth paths."""
    model = build_model(args)
    confidence = uses_confidence(args)
    device = next(model.parameters()).device
    h, w = model.spec.erp_h, model.spec.erp_w
    paths = list_inputs(args.input)
    stems = output_stems(paths, args.save_path)
    os.makedirs(args.save_path, exist_ok=True)

    written = []
    for start in range(0, len(paths), args.batch):
        chunk = paths[start : start + args.batch]
        frames = [np.load(p).astype(np.float32, copy=False) for p in chunk]
        for p, f in zip(chunk, frames):
            if f.shape != (h, w, 3):
                raise ValueError(f"{p}: expected an ({h}, {w}, 3) panorama, got {f.shape}")
        with torch.inference_mode():
            rgb = torch.from_numpy(np.stack(frames)).to(device)
            out = model(rgb, confidence=confidence)
            depth = (out[-1] if isinstance(out, list) else out)[..., 0].cpu().numpy()
        for stem, d in zip(stems[start : start + args.batch], depth):
            np.save(stem + "_depth.npy", d)
            written.append(stem + "_depth.npy")
            print(f"-> {stem}_depth.npy  [{d.min():.2f}, {d.max():.2f}]")
    return written


def main(argv=None):
    run_infer(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
