"""The program's spans in a traced run: ``harness.reduce_spans`` on a
synthetic Chrome trace, ``harness.span_window`` on the CPU, and the
readers of the span metrics."""

from __future__ import annotations

import time

import pytest

from benchmark import harness, program

WINDOW = {"ph": "X", "cat": "user_annotation", "name": harness.WINDOW, "ts": 0, "dur": 1000,
          "tid": 1}


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": harness.SPAN + name, "ts": ts,
            "dur": dur, "tid": tid}


def _launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 5, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


# a step on thread 1: train_step ⊃ forward, backward, optimizer; thread 2
# (autograd's) launches the backward's kernel and opens a span of its own
EVENTS = [
    WINDOW,
    _span("train_step", 10, 890), _span("forward", 10, 290), _span("backward", 300, 400),
    _span("optimizer", 700, 200), _span("encoder", 400, 100, tid=2),
    _launch(1, 20), _launch(2, 350, tid=2, cat="cuda_driver"), _launch(3, 750), _launch(4, 950),
    _launch(5, 60),
    _kernel(1, 100, 100), _kernel(2, 400, 200), _kernel(3, 800, 50, cat="gpu_memcpy"),
    _kernel(4, 960, 20), _kernel(5, 1500, 10),  # 5 runs after the window
    {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 100, "id": 1},
]


def test_device_time_is_inclusive_by_launch_and_idle_gaps_are_named_by_span():
    device, idle, busy = harness.reduce_spans(EVENTS)
    us = 1e-6
    assert device == pytest.approx({"train_step": 350 * us, "forward": 100 * us,
                                    "backward": 200 * us, "optimizer": 50 * us,
                                    harness.OUTSIDE: 20 * us})
    assert "encoder" not in device  # a span of another thread is not the step's
    assert busy == pytest.approx(370 * us)
    assert idle == pytest.approx({harness.OUTSIDE: 120 * us, "forward": 200 * us,
                                  "backward": 200 * us, "optimizer": 110 * us})
    assert busy + sum(idle.values()) == pytest.approx(1000 * us)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        harness.reduce_spans(EVENTS[1:])


def test_span_window_on_the_cpu_times_the_spans_on_the_host():
    from omnifusion_torch.utils.profiling import count, span

    def step(i):
        with span("outer"):
            with span("inner"):
                time.sleep(0.002)

    with program.recording() as setup:
        with span("tables"):
            count("tables.computed")
    s = harness.span_window(step, 3, "cpu", setup)
    assert not s.on_card and s.step_ms >= 2.0
    assert set(s.host_ms) == {"outer", "inner"} and s.host_ms["outer"] >= s.host_ms["inner"] >= 2.0
    assert s.device_ms == {} and s.idle_ms == {}
    assert set(s.setup_s) == {"tables"} and s.setup_counters == {"tables.computed": 1}


def _outcome(spans):
    return harness.Outcome({}, 0, 0, [], 0, {}, spans=spans)


READINGS = harness.Spans(True, 46.0, {"forward": 14.5}, device_ms={"encoder": 15.2},
                         setup_s={"kernel_library": 0.01, "tables": 0.8})


@pytest.mark.parametrize("name, value", [
    ("device_ms.encoder", 15.2), ("device_ms.heads", None),
    ("host_ms.forward", 14.5), ("host_ms.backward", None),
    ("setup_phase_s.kernels", 0.01), ("setup_phase_s.tables", 0.8), ("setup_phase_s.model", None),
])
def test_span_readers_read_their_span_or_nothing(name, value):
    read = harness.metric_reader(name).read
    assert read(None, _outcome(READINGS), name) == value
    assert read(None, _outcome(None), name) is None
    off_card = harness.Spans(False, **{k: getattr(READINGS, k) for k in (
        "step_ms", "host_ms", "device_ms", "setup_s")})
    assert read(None, _outcome(off_card), name) is None
