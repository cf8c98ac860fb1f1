"""Seeded weights, made on the device.

``make(cfg, seed, device)`` returns the model's state dict (the names of
``reference.model.param_specs``) in f32, the type the program serves its
parameters in: one ``torch.randn`` call on a ``torch.Generator`` of the
device fills every floating tensor, each leaf scaled by its kind
(convolutions and linear maps by 1/sqrt(fan_in), biases and the
positional embedding by 0.02, norm scales 1 + 0.1 N(0, 1), norm shifts
0.1 N(0, 1)). Then the BatchNorms' running statistics are set to the batch
statistics of the reference's trunk on one batch of seeded noise patches
(f32, TF32 off): the eval-mode model normalises its features as a trained
one does, so its depth and confidence are neither saturated nor
degenerate. The same seed gives the same state on one device type.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as ref

SCALES = {"bias": 0.02, "pos_emb": 0.02}


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


@torch.no_grad()
def make(cfg, seed: int, device) -> dict[str, torch.Tensor]:
    specs = ref.param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    floats = [(n, s, k) for n, s, k in specs if k not in ("bn_rm", "bn_rv", "bn_n")]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in floats), generator=gen, device=device)
    state, at = {}, 0
    for name, shape, kind in floats:
        x = flat[at:at + math.prod(shape)].reshape(shape)
        at += math.prod(shape)
        if kind in ("conv", "linear"):
            x = x / math.sqrt(_fan_in(shape))
        elif kind in ("bn_w", "ln_w"):
            x = 1.0 + 0.1 * x
        elif kind in ("bn_b", "ln_b"):
            x = 0.1 * x
        else:
            x = SCALES[kind] * x
        state[name] = x.contiguous()
    for name, shape, kind in specs:
        if kind == "bn_n":
            state[name] = torch.zeros((), dtype=torch.long, device=device)
        elif kind in ("bn_rm", "bn_rv"):
            state[name] = torch.zeros(shape, device=device) + (kind == "bn_rv")
    _calibrate(cfg, state, gen, device)
    return state


def _calibrate(cfg, state, gen, device):
    """Running statistics from one batch of seeded noise patches through
    the reference's trunk in train mode (each BatchNorm's batch mean and
    unbiased variance), with TF32 off."""
    stats = ref.RecordStats()
    p = dict(state)
    h, w = cfg["patch_size"]
    n = cfg["n_patches"]
    x = torch.rand(n, 3, h, w, generator=gen, device=device)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        geo = _geometry_input(cfg, device)
        pf = ref.points(p, ref.points_names(cfg)[0], geo, stats, "f32")
        pred, _ = ref.trunk(p, cfg, x, pf, 1, stats, ref.Precision())
        if cfg["model"] == "iterative":
            depth = torch.nn.functional.avg_pool2d(pred, 4)  # (P, 1, h/4, w/4)
            ref.points(p, "mlp_points2", geo * depth, stats, "f32")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for name, (mean, var) in stats.items():
        state[f"{name}.running_mean"] = mean.contiguous()
        state[f"{name}.running_var"] = var.contiguous()


def _geometry_input(cfg, device):
    """The first points embedding's input: the patch centres (one-shot) or
    the unit sphere (iterative) at quarter resolution."""
    import numpy as np

    from benchmark.reference import tables

    h, w = cfg["patch_size"]
    q = (h // 4, w // 4)
    if cfg["model"] == "iterative":
        a = tables.unit_sphere(q, cfg["fov"], cfg["nrows"])
    else:
        c = tables.centers_normalized(cfg["nrows"])
        a = np.concatenate([c, np.ones_like(c[:, :1]), c], -1)[:, :, None, None]
        a = np.broadcast_to(a, (*a.shape[:2], *q))
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32)
