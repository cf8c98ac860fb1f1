"""Process launch: one rank per process, spawned or started by torchrun.

``spawn`` starts ``world`` fresh interpreters (the ``spawn`` start method:
no state of the parent is forked into them, CUDA included), brings up each
rank's process group over a ``FileStore`` in a temporary directory (no TCP
port to pick, so concurrent launches never clash), runs ``fn(*args)`` in
each and returns their results in rank order. If a rank fails, or the
timeout passes, it kills every rank and raises. The entry points use it for
``--mesh DATA[,MODEL]`` (DATA * MODEL ranks on that mesh); the tests and
chip_smoke.py use it too.

Under ``torchrun`` the ranks already exist: ``torchrun_env`` reads the
rank, the world size and the local rank from the environment.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from omnifusion_torch.parallel.mesh import Mesh, destroy, init_process_group


def torchrun_env() -> Optional[tuple[int, int, int]]:
    """(rank, world size, local rank) when torchrun started this process,
    else None."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def _rank_main(fn, rank: int, world: int, args: tuple, device, backend, tmp: str,
               mesh: Optional[Mesh]) -> None:
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    init_process_group(rank, world, device, backend, store=store, mesh=mesh)
    try:
        out = fn(*args)
    finally:
        destroy()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, world: int, args: tuple = (),
          device_of_rank: Callable[[int], str] = lambda rank: f"cuda:{rank}",
          backend: Optional[str] = None, timeout_s: Optional[float] = None,
          mesh: Optional[Mesh] = None) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, rank r on
    ``device_of_rank(r)`` with its process group up (``backend``: nccl on
    CUDA, gloo on the CPU, unless named) on ``mesh`` (default: every
    rank on the data axis). ``fn`` and ``args`` must pickle: ``fn`` a
    module-level function. Returns each rank's result."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="omnifusion_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, r, world, args, device_of_rank(r), backend, tmp,
                                   mesh))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(f"rank {bad[0][0]} of {world} exited with code {bad[0][1]}")
                if all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
                procs[codes.index(None)].join(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
