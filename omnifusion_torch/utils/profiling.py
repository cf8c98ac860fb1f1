"""Profiling and timing helpers.

The port's counterpart of ``omnifusion_tpu/utils/profiling.py``:

- ``span(name)``, ``count(name, n)`` and ``recording()``: the program's
  spans and counters (below).
- ``trace(log_dir)``: a ``torch.profiler`` context over CPU and CUDA
  activity that writes a Chrome trace (``trace.json``) into ``log_dir``;
  the profile is the context's value.
- ``Throughput``: running panoramas/sec counter (the north-star metric).
- ``time_ms``: milliseconds per call of a callable: device time from CUDA
  events on a CUDA device (the launches queued behind a device-side sleep),
  host time on the CPU; ``time_ms_flushed``: the same with the L2 cache
  flushed before each call; ``device_and_wall_ms``: device and wall time
  of the same calls, as the tools report them.
- ``bound_ms``: the least time an H100 SXM could take for given bytes and
  operations; ``blend_bound``, ``spread_bound``, ``up2x_bound`` and
  ``up2x_adjoint_bound``: that bound for one call of each kernel.
- ``count_flops``, ``PEAK_FLOPS`` and ``mfu``: the model FLOPs of a call
  and their share of the card's peak (below).
- ``blend_matrix``: the blend's sparse map as a CSR matrix, for the library
  yardstick ``torch.sparse.mm`` (``sparse_csr`` builds one from COO parts).

FLOPs and MFU. The port's FLOPs are counted from shapes by
``torch.utils.flop_counter.FlopCounterMode``: convolutions (2 |out| kh kw
cin), ``mm``, ``addmm``, ``bmm`` and attention, over a forward, or over the
forward and backward of a train step (whose convolution backward counts
the data and weight gradients it computes). Elementwise work (BatchNorm,
ReLU, the blends, the upsamples, the optimizer) counts 0. The forward's
count equals the JAX model's convolutions and matmuls captured under
``jax.eval_shape`` (2 |out| kh kw cin, ``resize_impl="pallas"``;
tests/test_torch_port_measure.py), while XLA's ``cost_analysis`` counts
about 18% fewer on the same forward, so an MFU of the JAX tools and one of
the port are two different quantities. ``mfu`` is FLOPs over time against
the dense peak of the precision the work runs in (``PEAK_FLOPS``: f32 on
the CUDA cores, TF32 and bf16 on the tensor cores), with no allowance for
the elementwise work.

Spans. The port opens a span at each of its layer boundaries: ``model``
around a model's forward, with ``e2p``, ``points``, ``encoder``,
``transformer``, ``decoder``, ``heads`` and ``merge`` inside it (each pass
of the iterative model opens the trunk's and the merge's again;
``transformer`` holds ``transformer_blocks``, the ``TransformerCascade``
call, and, where the token is not layer4's width, ``up_proj``);
``train_step`` around an update, with ``forward``, ``loss``, ``backward``
and ``optimizer`` inside it; and in set-up ``kernel_library`` (the kernel
library built or loaded, ``ops/_build.py``) and ``tables`` (the projection
tables computed or read from disk, and the blend tables made and moved to
a device). Counters: ``kernel_library.built`` (nvcc ran),
``tables.computed``, ``tables.from_disk`` and ``tables.uploaded``; the
kernels' (``fused_heads.launches``, ``up2x.channels_last``,
``conv_epilogue.launches``, ``conv_fold.convs``, ``conv_fold.folds``,
``quad_blend.staged`` and ``quad_blend.global``, a blend launch by its
plan); ``up_proj.calls``, a pass through ``up_proj``.

Off, which is the default, ``span`` returns one shared context that does
nothing: it records nothing, allocates nothing and touches no CUDA API.
Under ``recording()`` each span appends ``(name, parent, thread,
start_ns, end_ns)`` to the recording's ``spans`` on
``time.perf_counter_ns()``, ``parent`` being the innermost span open on
the same thread, and ``count`` adds to its ``counters``. While a
``torch.profiler`` is active as well, each span also opens
``record_function("span:<name>")``, so that the profiler's Chrome trace
holds the spans on its own clock beside the host ops, the CUDA launches
and the device ops. Spans stay in memory; the profiler's trace is the only
thing written out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import subprocess
import threading
import time
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

if TYPE_CHECKING:
    from omnifusion_torch.ops.quad_blend import BlendTables

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# H100 SXM5 dense peaks by precision, NVIDIA data sheet: f32 outside the
# tensor cores, TF32 and bf16 on them (no sparsity)
PEAK_FLOPS = {"f32": 66.9e12, "tf32": 494.7e12, "bf16": 989.4e12}
F32_FLOPS = PEAK_FLOPS["f32"]
WINDOW_HOST_MS = 1.0  # time_ms: host time of the calls between two events
L2_BYTES = 50 * 2**20  # H100 SXM


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the innermost span open on the same thread
    thread: int  # threading.get_ident()
    start_ns: int  # time.perf_counter_ns()
    end_ns: int


@dataclasses.dataclass
class Recording:
    """The spans and counters recorded under ``recording()``."""

    spans: list = dataclasses.field(default_factory=list)  # Span, in the order they closed
    counters: dict = dataclasses.field(default_factory=dict)
    _open: threading.local = dataclasses.field(default_factory=threading.local, repr=False)

    def open_spans(self) -> list:
        """The names of the spans open on the calling thread, outermost first."""
        if not hasattr(self._open, "names"):
            self._open.names = []
        return self._open.names

    def seconds(self) -> dict:
        """Seconds of each span name, summed over its instances, in the
        order the names first closed."""
        out = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
        return out


_RECORDING: Optional[Recording] = None


class _NoSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "parent", "annotation", "start")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        names = self.rec.open_spans()
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(f"span:{self.name}")
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec.open_spans().pop()
        self.rec.spans.append(Span(self.name, self.parent, threading.get_ident(), self.start, end))
        return False


def span(name: str):
    """A context that records the span ``name`` under ``recording()`` and
    does nothing otherwise (the module's docstring)."""
    rec = _RECORDING
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` under ``recording()``."""
    rec = _RECORDING
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters for the duration; the ``Recording`` is
    the context's value. A recording entered inside another takes the
    spans until it ends."""
    global _RECORDING
    saved, rec = _RECORDING, Recording()
    _RECORDING = rec
    try:
        yield rec
    finally:
        _RECORDING = saved


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


def device_and_wall_ms(fn, device: torch.device, iters: int) -> dict:
    """A call of ``fn()`` timed twice: ``device_ms`` per call (``time_ms``
    after one warm call; None on the CPU), then ``wall_ms`` per call of
    ``iters`` more calls on the host's clock, ended by a synchronize;
    ``last`` is the last call's result."""
    on_card = device.type == "cuda"
    device_ms = time_ms(fn, device, iters, warmup=1) if on_card else None
    if not on_card:
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    if on_card:
        torch.cuda.synchronize(device)
    return {"device_ms": device_ms, "wall_ms": (time.perf_counter() - t0) * 1e3 / iters,
            "last": out}


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


def count_flops(fn) -> dict:
    """The FLOPs of one call of ``fn()``, counted from shapes (the module's
    docstring): {"total": int, "by_op": {aten op name: int}}."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    by_op = {str(op): int(n) for op, n in mode.get_flop_counts().get("Global", {}).items()}
    return {"total": int(mode.get_total_flops()), "by_op": by_op}


def trunk_precision(dtype=None) -> str:
    """The ``PEAK_FLOPS`` key of a trunk computing in ``dtype`` (None: f32,
    whose convolutions run in TF32 when cuDNN is allowed to)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "tf32" if torch.backends.cudnn.allow_tf32 else "f32"


def mfu(flops: float, ms: float, precision: str) -> float:
    """The share of the card's dense peak in ``precision`` that ``flops``
    in ``ms`` milliseconds make."""
    return flops / (ms / 1e3) / PEAK_FLOPS[precision]


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


def blend_work(x: torch.Tensor, tables: BlendTables, out: torch.Tensor) -> tuple[int, float]:
    """(bytes, operations) of one ``quad_blend`` call: the source pixels the
    tables read (``source_pixels``), the output and the tables read or
    written once; 8 operations per quad (4 multiply-adds) per source row.
    ``x`` and ``out`` may be meta tensors: only their shapes and dtypes
    count."""
    n_quads = int((tables.w4.sum(-1) > 0).sum().item()) + tables.n_tail
    src_bytes = x.numel() // tables.n_in * source_pixels(tables) * x.element_size()
    return (src_bytes + nbytes(out, tables.idx, tables.w4, tables.tail_ptr, tables.tail_idx,
                               tables.tail_w),
            8.0 * n_quads * x.numel() / tables.n_in)


def spread_work(cot: torch.Tensor, tables, out: torch.Tensor) -> tuple[int, float]:
    """(bytes, operations) of one ``quad_spread`` call on transposed
    ``tables``: the cotangent, the result and the tables read or written
    once; 8 operations per weighted quad per row."""
    t = tables
    n_entries = int((t.w_t.sum(-1) > 0).sum().item()) + t.n_over
    return (nbytes(cot, out, t.idx_t, t.w_t, t.over_ptr, t.over_src, t.over_w),
            8.0 * n_entries * cot.numel() / t.n_out)


def up2x_work(x: torch.Tensor) -> tuple[int, float]:
    """(bytes, operations) of one ``up2x`` call on ``x``: ``x`` read and its
    four times larger output written once; 9 operations per output."""
    return 5 * nbytes(x), 9.0 * 4 * x.numel()


def up2x_adjoint_work(x: torch.Tensor) -> tuple[int, float]:
    """(bytes, operations) of one ``up2x_adjoint`` call whose result has
    ``x``'s shape and dtype: the four times larger cotangent read and the
    result written once; 15 operations per result."""
    return 5 * nbytes(x), 15.0 * x.numel()


def blend_bound(x: torch.Tensor, tables: BlendTables, out: torch.Tensor) -> tuple[float, str]:
    """``bound_ms`` of one ``quad_blend`` call (``blend_work``)."""
    return bound_ms(*blend_work(x, tables, out))


def spread_bound(cot: torch.Tensor, tables, out: torch.Tensor) -> tuple[float, str]:
    """``bound_ms`` of one ``quad_spread`` call (``spread_work``)."""
    return bound_ms(*spread_work(cot, tables, out))


def up2x_bound(x: torch.Tensor) -> tuple[float, str]:
    """``bound_ms`` of one ``up2x`` call (``up2x_work``)."""
    return bound_ms(*up2x_work(x))


def up2x_adjoint_bound(x: torch.Tensor) -> tuple[float, str]:
    """``bound_ms`` of one ``up2x_adjoint`` call (``up2x_adjoint_work``)."""
    return bound_ms(*up2x_adjoint_work(x))


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
