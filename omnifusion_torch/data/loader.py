"""Multi-worker batching data loader (host-side).

The port's counterpart of ``omnifusion_tpu/data/loader.py``: a thread pool
builds samples while the card computes; batches are dicts of channel-last
numpy arrays (rgb, depth, mask; or rgb, labels from the segmentation
datasets). ``to_device`` replaces the JAX loader's ``prefetch_to_device``:
on a CUDA device each batch goes through pinned host memory with a
non-blocking copy, so the copy of the next batch overlaps the step that
runs on the current one.

Under data parallelism (``rank`` and ``world``) every rank draws the same
order of global batches from the same seed and loads only its contiguous
slice of each, so that the ranks together see the single-device batches,
as the JAX loader's batches sharded over the mesh's data axis. A batch that
the ranks cannot split evenly (the ragged tail with ``drop_last=False``) is
loaded whole on every rank, as the JAX loader replicates it. Batches are
``Batch`` dicts: ``sharded`` says whether this rank holds a slice of a
batch split over ranks.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator

import numpy as np
import torch


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
        flight ahead of the consumer."""
        device = torch.device(device)
        pin = device.type == "cuda"

        def put(b):
            out = Batch(sharded=b.sharded)
            for k, v in b.items():
                t = torch.from_numpy(v)
                out[k] = t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)
            return out

        queue = []
        for b in self:
            queue.append(put(b))
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
