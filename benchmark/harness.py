"""What every run shares: finding a cell's files by name, the run's
context, the device trace and the program's spans and their reduction,
the check, the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, whose file ``BENCHMARK.json`` gives, and a traffic mix,
read from ``benchmark/traffic/<traffic>.json``; its limits, the numbers
the check compares and the readings they were set from, are in
``benchmark/workloads/<cell>.json``. The configuration's ``model`` names
its kind: the program side ``benchmark/models/<model>.py``
(``program.kind``), the reference side ``benchmark/reference/<model>.py``
(``reference.model.kind``). The mix names its mode, the code of one kind
of window, ``benchmark/modes/<mode>.py``, which carries its CPU test sizes
(``SMALL``). A per-layer metric ``<stem>.<suffix>`` is read by
``benchmark/metrics/<stem>.<suffix>.py`` where that file exists, else by
``benchmark/metrics/<stem>.py``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "omnifusion_tpu")
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "bench_window"
LAUNCHES = "cuda_"  # CUDA runtime and driver calls; a launch carries its op's correlation id
SPAN = "span:"  # the prefix of the program's spans in a profiler's trace
OUTSIDE = "(none)"  # device time or idle time while no span was open


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: str = ROOT, overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files;
    ``overrides`` replace keys of the configuration or the traffic mix
    (the CPU tests' small sizes)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    for key, value in (overrides or {}).items():
        (config if key in config else traffic)[key] = value
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def mode_module(mode: str):
    return importlib.import_module(f"benchmark.modes.{mode}")


def metric_reader(name: str):
    """The module whose ``read(ctx, out)`` reads per-layer metric ``name``."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under benchmark/metrics/")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def fix_cache_dirs(root: str = ROOT) -> None:
    """Build and kernel caches in fixed directories of the checkout."""
    cache = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("OMNIFUSION_TORCH_TABLE_CACHE", os.path.join(root, ".table_cache_torch"))
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # host clock when the process began
    marks: list = dataclasses.field(default_factory=list)  # (set-up stage, host clock at its end)
    setup_record: object = None  # the program's spans and counters of set-up (record_setup)
    _recording: Optional[contextlib.ExitStack] = None

    def mark(self, stage: str):
        self.marks.append((stage, time.perf_counter()))

    def sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def record_setup(self):
        """Record the program's spans and counters from now until
        ``settle`` (``program.recording``), into ``setup_record``."""
        from benchmark import program

        self._recording = contextlib.ExitStack()
        self.setup_record = self._recording.enter_context(program.recording())

    def settle(self) -> float:
        """End of set-up: wait for the device, stop recording spans, collect
        the garbage of set-up and freeze what is left, so that no collection
        in the window walks it; returns ``setup_s``."""
        self.sync()
        if self._recording is not None:
            self._recording.close()
            self._recording = None
        gc.collect()
        gc.freeze()
        self.mark("settle")
        return time.perf_counter() - self.t_start


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Trace:
    """The reduction of one traced window."""

    window_s: float
    busy_s: float
    steps: int  # steps of the mode (batches, requests, train steps) traced
    kernels: list  # (name, seconds, category) of every device op, in order
    gaps: list  # (host activity, seconds) of every idle gap

    def top_ops(self, n=10):
        return _top(((name, s) for name, s, _ in self.kernels), n)

    def top_gaps(self, n=10):
        return _top(self.gaps, n)


def _top(pairs, n):
    """The n names with the most seconds, summed by name."""
    tot = {}
    for name, s in pairs:
        tot[name] = tot.get(name, 0.0) + s
    return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


@dataclasses.dataclass
class Spans:
    """The program's spans in the windows of ``span_window``, a step each
    (ms), and in set-up (s)."""

    on_card: bool
    step_ms: float  # window (a): host ms a step, spans recorded, no profiler
    host_ms: dict  # window (a): span -> host ms a step, summed over its instances
    device_ms: dict = dataclasses.field(default_factory=dict)  # (b): span -> device ms a step
    idle_ms: dict = dataclasses.field(default_factory=dict)  # (b): innermost span -> idle ms a step
    busy_ms: float = 0.0  # (b): device busy ms a step
    setup_s: dict = dataclasses.field(default_factory=dict)  # set-up: span -> seconds
    setup_counters: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    """What a mode returns."""

    e2e: dict  # end-to-end metric name -> value (setup_s included)
    attempted: int
    failed: int
    checks: list  # Check
    memory_peak_bytes: int
    facts: dict  # what the per-layer readers need (batch, rates, counts)
    trace: Optional[Trace] = None
    spans: Optional[Spans] = None


def trace_window(step: Callable[[int], None], n_steps: int, device: str,
                 gap_steps: int = 2) -> Trace:
    """Run ``step(i)`` for i < n_steps under ``torch.profiler`` tracing the
    device alone, and reduce its timeline: device busy time (the union of
    the device ops' intervals), every device op's time, and the window's
    length on the host's clock (from a synchronize before the first step
    to one after the last). Tracing the host's ops too would slow a
    host-bound step and the idle share with it; a second window of
    ``gap_steps`` steps traces them as well, and names each idle gap by
    the innermost host op running when it began."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if device != "cuda":
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        return Trace(time.perf_counter() - t0, 0.0, n_steps, [], [])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    dev = _device_ops(_events(prof))
    busy, _ = _busy_and_gaps(dev, dev[0][0] if dev else 0.0, dev[-1][1] if dev else 0.0)
    gaps = []
    if gap_steps:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for i in range(gap_steps):
                    step(n_steps + i)
                torch.cuda.synchronize()
        gaps = reduce_gaps(_events(prof))
    return Trace(window_s=t1 - t0, busy_s=busy / 1e6, steps=n_steps,
                 kernels=[(name, (e - s) / 1e6, cat) for s, e, name, cat in dev], gaps=gaps)


def span_window(step: Callable[[int], None], n_steps: int, device: str, setup=None) -> Spans:
    """Two more windows of ``n_steps`` steps with the program's spans
    recorded (``program.recording``), each ended by a synchronize: (a) no
    profiler: each span's host time, and the window's; (b) under a CPU and
    CUDA ``torch.profiler``: each span's device time, a device op counting
    in every span open on the stepping thread when its launch ran (the
    launch's correlation id; autograd's thread launches the backward while
    the stepping thread is in its ``backward`` span), and each idle gap
    named by the innermost span open on the stepping thread when it began
    (``reduce_spans``). On the CPU, (a) alone. ``setup``: the set-up's
    recording (``Context.setup_record``)."""
    import torch

    from benchmark import program

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    with program.recording() as rec:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        sync()
        t1 = time.perf_counter()
    out = Spans(device == "cuda", 1e3 * (t1 - t0) / n_steps,
                {k: 1e3 * s / n_steps for k, s in rec.seconds().items()})
    if setup is not None:
        out.setup_s, out.setup_counters = setup.seconds(), dict(setup.counters)
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile, record_function

        with program.recording(), profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for i in range(n_steps):
                    step(n_steps + i)
                torch.cuda.synchronize()
        device_s, idle_s, busy_s = reduce_spans(_events(prof))
        out.device_ms = {k: 1e3 * s / n_steps for k, s in device_s.items()}
        out.idle_ms = {k: 1e3 * s / n_steps for k, s in idle_s.items()}
        out.busy_ms = 1e3 * busy_s / n_steps
    return out


def reduce_spans(events: list) -> tuple[dict, dict, float]:
    """(span -> device seconds, innermost span -> idle seconds, busy
    seconds) of the window annotation of a trace of host and device ops
    and the program's ``span:`` ranges (``span_window``). The stepping
    thread is the annotation's; a device op whose launch ran while no span
    was open there counts under ``OUTSIDE``, as does an idle gap."""
    ws, we, tid = _window(events)
    # (start, end, name), outermost first where two start together
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                      e["name"][len(SPAN):]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e.get("tid") == tid and e.get("name", "").startswith(SPAN)),
                    key=lambda r: (r[0], -r[1]))

    def open_at(t):  # the spans open at t, outermost first
        return [name for s, e, name in ranges if s <= t <= e]

    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("ph") == "X" and e.get("cat", "").startswith(LAUNCHES)
              and "correlation" in e.get("args", {})}
    device = collections.defaultdict(float)
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_OPS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s0, s1 = max(s, ws), min(s + d, we)
        if s1 <= s0:
            continue
        dev.append((s0, s1, e["name"], e["cat"]))
        t = launch.get(e.get("args", {}).get("correlation"))
        for name in (set(open_at(t)) if t is not None else set()) or {OUTSIDE}:
            device[name] += (s1 - s0) / 1e6
    busy, gaps = _busy_and_gaps(sorted(dev), ws, we)
    idle = collections.defaultdict(float)
    for start, length in gaps:
        inner = open_at(start)
        idle[inner[-1] if inner else OUTSIDE] += length / 1e6
    return dict(device), dict(idle), busy / 1e6


def _window(events: list) -> tuple[float, float, object]:
    """(start, end, thread) of the window annotation."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    ws = float(win[0]["ts"])
    return ws, ws + float(win[0]["dur"]), win[0].get("tid")


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = load_json(path)
    finally:
        os.unlink(path)
    return events["traceEvents"] if isinstance(events, dict) else events


def _device_ops(events, lo=-math.inf, hi=math.inf) -> list:
    """(start, end, name, category) in microseconds of every device op,
    clipped to [lo, hi], in order."""
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_OPS:
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            s0, s1 = max(s, lo), min(s + d, hi)
            if s1 > s0:
                dev.append((s0, s1, e["name"], e["cat"]))
    return sorted(dev)


def _busy_and_gaps(dev, ws, we):
    """The busy time of the ops ``dev`` within [ws, we] and the idle gaps
    (start, length) between them."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, ws
    for s, e, _, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s - cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if we > cur_e:
        gaps.append((cur_e, we - cur_e))
    return busy, gaps


def reduce_gaps(events: list) -> list:
    """(host activity, seconds) of every idle gap of the device within the
    window annotation of a trace of host and device ops."""
    ws, we, _ = _window(events)
    _, gaps = _busy_and_gaps(_device_ops(events, ws, we), ws, we)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_OPS)
    names = _host_at([g for g, _ in gaps], host)
    return [(name, d / 1e6) for name, (_, d) in zip(names, gaps)]


def _host_at(times: list, host: list) -> list:
    """For each time (ascending), the innermost host op running then."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host: between ops")
    return out


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def result_line(cell: Cell, out: Outcome, trace: bool, device: str) -> dict:
    """The run's last line (``correct`` ... ``checks``, the compared
    numbers, last)."""
    correct = bool(out.checks) and out.failed == 0 and all(c.ok for c in out.checks)
    metrics = {}
    if device == "cuda":
        if trace:
            for m in cell.per_layer:
                value = metric_reader(m["name"]).read(cell, out, m["name"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info(cell, out, trace, device)}
    if trace and out.trace is not None and device == "cuda":
        line["breakdown"] = {"device_ops": [[n, s] for n, s in out.trace.top_ops()],
                             "idle_gaps": [[n, s] for n, s in out.trace.top_gaps()]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def device_info(cell: Cell, out: Outcome, trace: bool, device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": None}
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "memory_peak_bytes": out.memory_peak_bytes}
    if trace and out.trace is not None:
        info["busy_s"] = out.trace.busy_s
        info["window_s"] = out.trace.window_s
    return info

