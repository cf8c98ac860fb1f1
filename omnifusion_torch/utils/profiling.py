"""Profiling and timing helpers.

The port's counterpart of ``omnifusion_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` context over CPU and CUDA
  activity that writes a Chrome trace (``trace.json``) into ``log_dir``;
  the profile is the context's value.
- ``Throughput``: running panoramas/sec counter (the north-star metric).
- ``time_ms``: milliseconds per call of a callable: device time from CUDA
  events on a CUDA device (the launches queued behind a device-side sleep),
  host time on the CPU; ``time_ms_flushed``: the same with the L2 cache
  flushed before each call.
- ``bound_ms``: the least time an H100 SXM could take for given bytes and
  operations; ``blend_bound``: that bound for one ``quad_blend`` call.
- ``blend_matrix``: the blend's sparse map as a CSR matrix, for the library
  yardstick ``torch.sparse.mm`` (``sparse_csr`` builds one from COO parts).
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import time

import torch

from omnifusion_torch.ops.quad_blend import BlendTables

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
WINDOW_HOST_MS = 1.0  # time_ms: host time of the calls between two events
L2_BYTES = 50 * 2**20  # H100 SXM


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Running items/sec over a sliding window of step timestamps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: list[tuple[float, int]] = []

    def update(self, n_items: int):
        self._events.append((time.perf_counter(), n_items))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        items = sum(n for _, n in self._events[1:])
        return items / dt if dt > 0 else 0.0


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, device: torch.device, iters: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()`` after ``warmup`` calls.

    On a CUDA device: the device time of ``iters`` calls between CUDA
    events. The calls queue behind a device-side sleep long enough to cover
    their enqueue, so the events time the kernels and not the host's launch
    rate. The launch queue holds about a thousand launches, and a host that
    fills it waits for the device, so a window between two events holds only
    the calls the host enqueues in about WINDOW_HOST_MS: one, for a forward
    of a few hundred launches; all ``iters``, for one kernel. On the CPU:
    the host time."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    per_window = max(1, min(iters, int(WINDOW_HOST_MS / max(host_ms, 1e-6))))
    total, done = 0.0, 0
    while done < iters:
        n = min(per_window, iters - done)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2.0 * host_ms * n + 2.0) * _sleep_cycles_per_ms()))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
        done += n
    return total / iters


def time_ms_flushed(fn, device: torch.device, iters: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()`` as a caller finds it whose inputs
    are not in the L2 cache: before each call the device reads 2 x L2_BYTES
    of its own, which evicts what the last call left there (a read leaves
    no dirty lines to write back during the call). On a CUDA device: the
    device time between CUDA events around each call, all calls queued
    behind a device-side sleep; on the CPU: ``time_ms``."""
    if device.type != "cuda":
        return time_ms(fn, device, iters, warmup)
    flush = torch.ones(2 * L2_BYTES // 4, device=device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    flush.sum()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(int((2.0 * host_ms * iters + 2.0) * _sleep_cycles_per_ms()))
    for start, end in pairs:
        flush.sum()
        start.record()
        fn()
        end.record()
    pairs[-1][1].synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def gpu_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the f32 operations over its f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def source_pixels(tables: BlendTables) -> int:
    """The distinct source pixels that the tables' corners read with weight
    (the quarter-resolution equi2pers reads 13% of the ERP, the flagship's
    87%, a merge all of its patches)."""
    offs = torch.tensor([0, 1, tables.row_stride, tables.row_stride + 1],
                        device=tables.idx.device)
    parts = [((tables.idx.long()[..., None] + offs) % tables.n_in)[tables.w4 != 0]]
    if tables.n_tail:
        parts.append(((tables.tail_idx.long()[:, None] + offs) % tables.n_in)[tables.tail_w != 0])
    return int(torch.unique(torch.cat(parts)).numel())


def blend_bound(x: torch.Tensor, tables: BlendTables, out: torch.Tensor) -> tuple[float, str]:
    """``bound_ms`` of one ``quad_blend`` call: the source pixels the tables
    read (``source_pixels``), the output and the tables read or written
    once; 8 operations per quad (4 multiply-adds) per source row."""
    n_quads = int((tables.w4.sum(-1) > 0).sum().item()) + tables.n_tail
    src_bytes = x.numel() // tables.n_in * source_pixels(tables) * x.element_size()
    return bound_ms(
        src_bytes + nbytes(out, tables.idx, tables.w4, tables.tail_ptr, tables.tail_idx,
                           tables.tail_w),
        8.0 * n_quads * x.numel() / tables.n_in,
    )


def sparse_csr(rows, cols, vals, shape) -> torch.Tensor:
    """A CSR matrix from COO parts, zero values dropped."""
    keep = vals != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), vals[keep], shape, check_invariants=False
    )
    return coo.coalesce().to_sparse_csr()


def blend_matrix(tables: BlendTables, dtype=torch.float32) -> torch.Tensor:
    """The blend's sparse map as a CSR (N_out, N_in) matrix in ``dtype``,
    for the library yardstick torch.sparse.mm."""
    n_in, w = tables.n_in, tables.row_stride
    rows = [torch.arange(tables.n_out, device=tables.idx.device).repeat_interleave(tables.k)]
    cols = [tables.idx.long().reshape(-1)]
    vals = [tables.w4.reshape(-1, 4)]
    if tables.n_tail:
        rows.append(tables.tail_pix.long())
        cols.append(tables.tail_idx.long())
        vals.append(tables.tail_w)
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    return sparse_csr(
        torch.cat([r] * 4),
        torch.cat([(c + off) % n_in for off in (0, 1, w, w + 1)]),
        torch.cat([v[:, q] for q in range(4)]).to(dtype),
        (tables.n_out, n_in),
    )
