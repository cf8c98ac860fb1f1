"""Multi-worker batching data loader (host-side).

The port's counterpart of ``omnifusion_tpu/data/loader.py``: a thread pool
builds samples while the card computes; batches are dicts of channel-last
numpy arrays (rgb, depth, mask; or rgb, labels from the segmentation
datasets). ``to_device`` replaces the JAX loader's ``prefetch_to_device``:
on a CUDA device each batch goes through pinned host memory with a
non-blocking copy, so the copy of the next batch overlaps the step that
runs on the current one.

Under data parallelism (``rank`` and ``world``: the data rank and the data
axis's size) every data group draws the same order of global batches from
the same seed and loads only its contiguous slice of each, so that the
data groups together see the single-device batches, as the JAX loader's
batches sharded over the mesh's data axis. A batch that the data groups
cannot split evenly (the ragged tail with ``drop_last=False``) is loaded
whole on every rank, as the JAX loader replicates it. Batches are ``Batch``
dicts: ``sharded`` says whether this rank holds a slice of a batch split
over the data axis.

Under a model axis the model ranks of a data group split the same
panoramas, so they must hold the same samples. The datasets draw their
augmentations from one generator per dataset, in the order the worker
threads reach the samples, so ranks that loaded on their own could hold
differently augmented copies. ``to_device`` therefore loads each batch on
model rank 0 of the data group alone and broadcasts it over the model
group.
"""

from __future__ import annotations

import concurrent.futures
import itertools
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from omnifusion_torch.parallel import mesh


class Batch(dict):
    """A batch's arrays by name; ``sharded``: this rank holds its slice of
    a global batch that is split over ranks."""

    def __init__(self, *args, sharded: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.sharded = sharded


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = True,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self.rank, self.world = rank, world
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        end = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)
        for s in range(0, end, self.batch_size):
            yield idx[s : s + self.batch_size]

    def _rank_indices(self, indices) -> tuple[np.ndarray, bool]:
        """This rank's part of a global batch, and whether it is a slice."""
        if self.world == 1 or len(indices) % self.world:
            return indices, False
        k = len(indices) // self.world
        return indices[self.rank * k : (self.rank + 1) * k], True

    def _load_batch(self, indices) -> Batch:
        indices, sharded = self._rank_indices(indices)
        samples = [self.dataset[int(i)] for i in indices]
        cols = [np.stack(x) for x in zip(*samples)]
        if len(cols) == 2:  # segmentation datasets: (rgb, labels)
            return Batch(rgb=cols[0], labels=cols[1], sharded=sharded)
        return Batch(rgb=cols[0], depth=cols[1], mask=cols[2], sharded=sharded)

    def to_device(self, device) -> Iterator[Batch]:
        """Iterate batches as tensors on ``device``, keeping two copies in
        flight ahead of the consumer. Under a model axis, model rank 0 of
        each data group loads them and the others receive them."""
        device = torch.device(device)
        pin = device.type == "cuda"

        def put(b):
            out = Batch(sharded=b.sharded)
            for k, v in b.items():
                t = torch.from_numpy(v)
                out[k] = t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)
            return out

        share = mesh.model_world() > 1
        loads = not share or mesh.model_rank() == 0
        queue = []
        for b in self if loads else itertools.repeat(None, len(self)):
            b = None if b is None else put(b)
            queue.append(_from_model_root(b, device) if share else b)
            if len(queue) > 2:
                yield queue.pop(0)
        yield from queue

    def __iter__(self) -> Iterator[Batch]:
        self._epoch += 1
        batches = list(self._batch_indices())
        if self.num_workers <= 1:
            for b in batches:
                yield self._load_batch(b)
            return
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            window = self.num_workers * 2  # batches in flight
            futures = [pool.submit(self._load_batch, b) for b in batches[:window]]
            next_submit = window
            for i in range(len(batches)):
                yield futures[i].result()
                futures[i] = None
                if next_submit < len(batches):
                    futures.append(pool.submit(self._load_batch, batches[next_submit]))
                    next_submit += 1


def _from_model_root(b: Optional[Batch], device) -> Batch:
    """Model rank 0's batch ``b`` on every rank of its model group (``b``
    is None on the others): its layout, then each tensor, broadcast over
    the model group."""
    src, group = mesh.data_rank() * mesh.model_world(), mesh.model_group()
    head = [None if b is None else (b.sharded, {k: (t.shape, t.dtype) for k, t in b.items()})]
    dist.broadcast_object_list(head, src=src, group=group)
    sharded, layout = head[0]
    if b is None:
        b = Batch({k: torch.empty(shape, dtype=dtype, device=device)
                   for k, (shape, dtype) in layout.items()}, sharded=sharded)
    for t in b.values():
        dist.broadcast(t, src=src, group=group)
    return b
