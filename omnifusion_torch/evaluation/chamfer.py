"""Chamfer distance between point sets.

The port's counterpart of ``omnifusion_tpu/evaluation/chamfer.py`` (parity:
util.py:201-257). The reference materializes the full (N, M) pairwise
tensor; here, as in the JAX package, the rows of ``p1`` go in blocks, so
large clouds fit in memory, with the same result: the sum over the batch of
sum_i min_j ||p1_i - p2_j||. The squared differences are computed
explicitly: ``torch.cdist``'s matmul form (|a|^2 + |b|^2 - 2ab, its default
above 25 rows) loses the small distances. The last block is the rows that
are left (where the JAX package zero-pads it and masks the padding out).
"""

from __future__ import annotations

import torch


def chamfer_distance(p1: torch.Tensor, p2: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """One-directional chamfer distance (matches the reference's direction).

    p1: (B, N, D); p2: (B, M, D) -> scalar sum over batch and points of the
    distance from each p1 point to its nearest p2 point.
    """
    total = torch.zeros((), dtype=p1.dtype, device=p1.device)
    for i in range(0, p1.shape[1], block):
        pb = p1[:, i : i + block]
        d2 = (pb[:, :, None, :] - p2[:, None, :, :]).square().sum(-1)
        total = total + d2.min(dim=-1).values.sqrt().sum()
    return total


def chamfer_distance_symmetric(p1: torch.Tensor, p2: torch.Tensor,
                               block: int = 1024) -> torch.Tensor:
    """Symmetric variant: chamfer(p1 -> p2) + chamfer(p2 -> p1)."""
    return chamfer_distance(p1, p2, block) + chamfer_distance(p2, p1, block)
