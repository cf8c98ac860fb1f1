"""The program side of the model kind ``oneshot``: the port's
``SphericalFusion``."""

from __future__ import annotations

from benchmark import program


def build(cfg, precision: dict, state: dict, device):
    from omnifusion_torch.models import SphericalFusion

    return program.build_model(SphericalFusion, cfg, precision, state, device,
                               merge_dtype=program.DTYPES[precision["merge"]])


def outputs(out) -> list:
    """A forward's depth (B, H, W, 1), as the one pass."""
    return [out]


def train_step(state, batch):
    """``training.train_step`` on the batch's rgb, depth and mask."""
    from omnifusion_torch.training import train_step as step

    return step(state, batch)
