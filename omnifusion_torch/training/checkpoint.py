"""Checkpoints of the full train state.

The port's counterpart of ``omnifusion_tpu/training/checkpoint.py``: the
update count, the model's state dict (parameters and BatchNorm statistics),
the optimizer's state and the schedule go into one ``torch.save`` file per
name, ``latest`` and ``best`` side by side, and a restore resumes exactly.
Writes are atomic (a temporary file, then ``os.replace``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch

from omnifusion_torch.training.schedule import CosineWarmRestarts


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, state, name: str = "latest") -> None:
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "schedule": dataclasses.asdict(state.schedule),
        }
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        try:
            torch.save(payload, tmp)
            os.replace(tmp, self.path(name))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def restore(self, state, name: str = "latest"):
        """Load ``name`` into ``state``; returns it."""
        return restore_file(state, self.path(name))

    def exists(self, name: str = "latest") -> bool:
        return os.path.exists(self.path(name))


def restore_file(state, path: str):
    """Load the checkpoint file ``path`` into ``state`` (same model and
    optimizer layout); returns it."""
    device = next(state.model.parameters()).device
    return restore_state(state, torch.load(path, map_location=device, weights_only=True))


def restore_state(state, ckpt: dict):
    """Load a checkpoint that ``CheckpointManager.save`` wrote, read with
    ``torch.load``, into ``state``; returns it."""
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.schedule = CosineWarmRestarts(**ckpt["schedule"])
    state.step = int(ckpt["step"])
    return state
