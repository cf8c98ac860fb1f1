"""The program side of the model kind ``iterative``: the port's
``SphericalFusionIterative``."""

from __future__ import annotations

from benchmark import program


def build(cfg, precision: dict, state: dict, device):
    from omnifusion_torch.models import SphericalFusionIterative

    return program.build_model(SphericalFusionIterative, cfg, precision, state, device,
                               merge_dtype=program.DTYPES[precision["merge"]],
                               num_iters=cfg["num_iters"])


def outputs(out) -> list:
    """Each pass's depth (B, H, W, 1) of a forward; the last is the one
    served."""
    return list(out)


def train_step(state, batch):
    """``training.train_step`` on the batch's rgb, depth and mask (the
    mean of the passes' losses)."""
    from omnifusion_torch.training import train_step as step

    return step(state, batch)
