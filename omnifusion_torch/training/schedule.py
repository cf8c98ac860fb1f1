"""Learning-rate schedule.

The port's counterpart of ``omnifusion_tpu/training/schedule.py``: torch's
CosineAnnealingWarmRestarts as the reference trainers use it (T_0=5,
T_mult=2, stepped once per epoch), evaluated per optimizer step.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CosineWarmRestarts:
    """lr(e) = base * (1 + cos(pi * T_cur / T_i)) / 2 with epoch
    e = step // steps_per_epoch, T_i = t_0 * t_mult^i the length of the
    cycle that holds e and T_cur the epochs since its start (eta_min 0, as
    the reference trainers use it)."""

    base_lr: float
    t_0: int
    t_mult: int = 1
    steps_per_epoch: int = 1

    def __post_init__(self):
        if self.t_mult < 1 or self.t_0 < 1 or self.steps_per_epoch < 1:
            raise ValueError(f"bad schedule {self}")

    def __call__(self, step: int) -> float:
        t_cur, t_i = step // self.steps_per_epoch, self.t_0
        while t_cur >= t_i:  # whole cycles, in integers
            t_cur -= t_i
            t_i *= self.t_mult
        return self.base_lr * (1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0


def cosine_warm_restarts(
    base_lr: float, t_0: int, t_mult: int = 1, steps_per_epoch: int = 1
) -> CosineWarmRestarts:
    return CosineWarmRestarts(base_lr, t_0, t_mult, steps_per_epoch)
