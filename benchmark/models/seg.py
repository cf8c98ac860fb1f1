"""The program side of the model kind ``seg``: the port's
``SphericalFusionSeg``."""

from __future__ import annotations

from benchmark import program


def build(cfg, precision: dict, state: dict, device):
    """The model merges its logits in f32 whatever its trunk; a mix that
    asks for another merge is refused, since the yardstick would count
    the merge's bytes in that type."""
    from omnifusion_torch.models import SphericalFusionSeg

    if precision["merge"] != "f32":
        raise ValueError(f"SphericalFusionSeg merges in f32, not {precision['merge']}")
    return program.build_model(SphericalFusionSeg, cfg, precision, state, device,
                               num_classes=cfg["num_classes"])


def outputs(out) -> list:
    """A forward's logits (B, H, W, num_classes), as the one pass."""
    return [out]


def train_step(state, batch):
    """``training.train_step_sem`` on the batch's rgb and labels."""
    from omnifusion_torch.training import train_step_sem

    return train_step_sem(state, batch)
