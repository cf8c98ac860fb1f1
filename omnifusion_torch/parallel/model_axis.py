"""The mesh's model axis: the folded B * P patch stack split over the model ranks.

The port's counterpart of the JAX package's patch sharding
(``omnifusion_tpu/models/spherical_fusion.py:104-107``): there GSPMD keeps
the rows of the folded (B * P, ...) patch stack on the (data, model)
devices and inserts an all-gather of the tokens before the transformer.
Here each model rank keeps its contiguous chunk of its data group's rows
(``shard_rows``: ``torch.tensor_split``, so chunks may differ by one row)
and runs the trunk on it; two gathers cross the model group:

- ``gather_tokens``: the ``down(l4)`` tokens before the transformer, which
  needs whole panoramas. Each rank runs the transformer on every token but
  differentiates only its own rows' outputs, so the cotangent of the
  gathered tokens is a partial one: the backward sums it over the model
  group, then keeps this rank's rows.
- ``gather_patches``: pred and conf before the merge. Every model rank
  then merges the whole group's patches and computes the whole loss of its
  data group, so the cotangent of the gathered patches is the same on every
  rank: the backward keeps this rank's rows, with no sum (a sum would
  count it MODEL times).

``sum_cotangent`` is the gather_tokens backward's sum on its own: the
identity forward, a sum over the model group backward. The iterative
model's feedback depth takes it: each rank's next pass reads its own rows
of that replicated depth, so its cotangent there is a partial one too.

So every parameter's gradient on a rank is its rows' part of the data
group's gradient: the DDP wrap sums the gradients over the model axis and
averages them over the data axis (``parallel/ddp.py``). The gathers pad
unequal chunks to the largest and trim after, and use ``all_gather`` and
``all_reduce``, which gloo runs on CPU and CUDA tensors alike. With no model
axis (no group up, or MODEL = 1) all of these are the identity: no copy and
no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from omnifusion_torch.parallel.mesh import all_reduce_, model_group, model_rank, model_world


def row_chunks(n: int) -> list[int]:
    """The rows of each model rank's chunk of ``n`` rows, in rank order
    (``torch.tensor_split``'s sizes)."""
    m = model_world()
    return [n // m + (1 if r < n % m else 0) for r in range(m)]


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This model rank's chunk of ``x``'s rows (dim 0): a view. Its
    backward is this chunk's cotangent, zero elsewhere: the rank's part."""
    m = model_world()
    return x if m == 1 else torch.tensor_split(x, m)[model_rank()]


class _GatherRows(torch.autograd.Function):
    """The model group's chunks concatenated along dim 0 (``n`` rows in
    all); the backward is this rank's rows of the cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int) -> torch.Tensor:
        chunks = row_chunks(n)
        if x.shape[0] != chunks[model_rank()]:
            raise ValueError(f"model rank {model_rank()} holds {x.shape[0]} rows, not "
                             f"{chunks[model_rank()]} of {n}")
        pad = x.new_zeros((chunks[0], *x.shape[1:]))
        pad[: x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in chunks]
        dist.all_gather(parts, pad, group=model_group())
        return torch.cat([p[:c] for p, c in zip(parts, chunks)])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return shard_rows(g), None


class _SumCotangent(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the model group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce_(g.clone(), group=model_group())


def sum_cotangent(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose cotangent each model rank holds a part of (its own
    rows' consumers): the backward sums the parts."""
    return x if model_world() == 1 else _SumCotangent.apply(x)


def gather_patches(x: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` rows of the model group, each rank's chunk of them in
    ``x``, for a computation that every model rank runs whole up to the
    loss; the backward keeps this rank's rows."""
    return x if model_world() == 1 else _GatherRows.apply(x, n)


def gather_tokens(x: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` rows of the model group, for a computation whose output
    each rank differentiates only at its own rows (the transformer); the
    backward sums the cotangent over the model group, then keeps this
    rank's rows."""
    return x if model_world() == 1 else sum_cotangent(_GatherRows.apply(x, n))
