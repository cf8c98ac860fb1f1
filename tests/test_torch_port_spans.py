"""The port's spans and counters (``utils/profiling.py``), on the CPU at
64x128, patch 32, with one-block encoders and a one-layer transformer.

- Off, the default: a forward and a train step open no profiler range,
  check no profiler and touch no CUDA API, and ``span`` hands back one
  shared context.
- Under ``recording()``: the one-shot, iterative and segmentation
  forwards and a train step record the layer spans, each with its parent,
  nested in time (the segmentation merge's blend in ``merge_blend``,
  inside ``merge``; ``transformer_blocks`` and ``up_proj`` inside
  ``transformer``), and the counter ``up_proj.calls`` once a pass.
- The set-up counters: a spec's tables counted once as computed or read
  from disk and as uploaded, in two ``tables`` spans that do not nest, a
  second call counting nothing; the kernel library counted as built only
  when nvcc runs (a stand-in nvcc).
- With a profiler active, each span is a ``span:<name>`` range in the
  exported Chrome trace.
"""

import collections
import json
import os
import stat
import types

import numpy as np
import pytest
import torch

from omnifusion_torch.models import (SphericalFusion, SphericalFusionIterative,
                                     SphericalFusionSeg, init_weights)
from omnifusion_torch.ops import _build
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.projection.spec import build_equi2pers_grids, build_pers2equi_grids
from omnifusion_torch.training import create_train_state, train_step
from omnifusion_torch.utils import profiling
from omnifusion_torch.utils.profiling import count, recording, span

ERP, PATCH = (64, 128), 32
ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
STAGES = ["e2p", "points", "encoder", "transformer", "decoder", "heads", "merge"]
TRUNK = ["encoder", "transformer", "decoder", "heads", "merge"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def models():
    spec = ProjectionSpec.create(ERP, (PATCH, PATCH), (80.0, 80.0), 4)
    kw = dict(depth=1, encoder_stages=ONE_BLOCK, device="cpu")
    return {"oneshot": init_weights(SphericalFusion(spec, **kw), 0),
            "iterative": init_weights(SphericalFusionIterative(spec, **kw), 0),
            "seg": init_weights(SphericalFusionSeg(spec, **kw), 0)}


def _batch(b: int = 1) -> dict:
    rng = np.random.default_rng(0)
    return {"rgb": torch.from_numpy(rng.random((b, *ERP, 3), dtype=np.float32)),
            "depth": torch.from_numpy(rng.random((b, *ERP, 1), dtype=np.float32) * 7 + 0.3),
            "mask": torch.ones(b, *ERP, 1)}


def _run(models, what: str):
    """One forward of a model, or one train step of the one-shot model."""
    batch = _batch()
    if what == "train_step":
        return train_step(create_train_state(models["oneshot"]), batch)["loss"]
    with torch.inference_mode():
        return models[what].eval()(batch["rgb"])


def _refuse(*args, **kwargs):
    raise AssertionError("called with the spans off")


@pytest.mark.parametrize("what", ["oneshot", "iterative", "train_step"])
def test_spans_off_by_default_touch_no_profiler_and_no_cuda(models, what, monkeypatch):
    _run(models, what)  # the tables and the first call's work, before the guards
    assert profiling._RECORDING is None
    # the names the recorder reaches the profiler and the card by (torch's
    # own modules, the optimizer's range among them, keep theirs)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(profiling.torch.autograd, "_profiler_enabled", _refuse)
    for name in ("is_available", "synchronize", "current_stream", "Event"):
        monkeypatch.setattr(torch.cuda, name, _refuse)
    _run(models, what)
    assert span("model") is span("train_step") is profiling._NO_SPAN
    count("tables.computed")
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {} and profiling._RECORDING is None


def _in_model(stages):
    """(span, parent) of ``stages`` closing inside ``model``: patch 32's token
    is 32 wide, not layer4's 512, so ``transformer`` holds
    ``transformer_blocks`` and ``up_proj``."""
    out = []
    for s in stages:
        if s == "transformer":
            out += [("transformer_blocks", s), ("up_proj", s)]
        out.append((s, "model"))
    return out


EXPECTED = {
    "oneshot": _in_model(STAGES) + [("model", None)],
    "iterative": _in_model(STAGES + ["points"] + TRUNK) + [("model", None)],
    "seg": _in_model(STAGES[:-1]) + [
        ("merge_blend", "merge"), ("merge", "model"), ("model", None)],
    "train_step": _in_model(STAGES) + [
        ("model", "forward"), ("forward", "train_step"), ("loss", "train_step"),
        ("backward", "train_step"), ("optimizer", "train_step"), ("train_step", None)],
}


@pytest.mark.parametrize("what", sorted(EXPECTED))
def test_recorded_spans_nest_with_their_parents(models, what):
    _run(models, what)  # warm: no set-up spans in the recorded call
    with recording() as rec:
        _run(models, what)
    assert [(s.name, s.parent) for s in rec.spans] == EXPECTED[what]
    # a pass through up_proj each (the plain blends count no plan on the CPU)
    assert rec.counters == {"up_proj.calls": 2 if what == "iterative" else 1}
    outer = rec.spans[-1]
    for s in rec.spans:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        assert s.thread == outer.thread
    assert profiling._RECORDING is None


@pytest.mark.parametrize("kind", ["e2p", "p2e"])
def test_table_counters(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("OMNIFUSION_TORCH_TABLE_CACHE", str(tmp_path))
    # a spec that no other test builds, so that the process's caches miss
    spec = ProjectionSpec.create((32, 64), (16, 16), (77.0, 77.0), 4)
    grids, tables = {"e2p": (build_equi2pers_grids, equi2pers_tables),
                     "p2e": (build_pers2equi_grids, pers2equi_tables)}[kind]
    with recording() as rec:
        tables(spec, torch.device("cpu"))
    assert rec.counters == {"tables.computed": 1, "tables.uploaded": 1}
    # the grids, then the blend tables made from them and moved to the device
    assert [(s.name, s.parent) for s in rec.spans] == [("tables", None), ("tables", None)]
    grids_span, upload_span = rec.spans
    assert grids_span.end_ns <= upload_span.start_ns
    assert rec.seconds() == {
        "tables": pytest.approx(sum(s.end_ns - s.start_ns for s in rec.spans) / 1e9)}
    with recording() as rec:
        tables(spec, torch.device("cpu"))
        grids(spec)
    assert rec.spans == [] and rec.counters == {}
    with recording() as rec:
        grids.__wrapped__(spec)  # as a later process finds them: on the disk
    assert rec.counters == {"tables.from_disk": 1}
    assert [(s.name, s.parent) for s in rec.spans] == [("tables", None)]


class _FakeLibrary:
    """A loaded library whose entries take any argtypes and restype."""

    def __init__(self, path):
        assert os.path.exists(path)

    def __getattr__(self, name):
        entry = types.SimpleNamespace()
        setattr(self, name, entry)
        return entry


def test_kernel_library_span_and_build_counter(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    # a stand-in nvcc: touches the file it is asked to write
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then touch "$2"; fi\n  shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLibrary)
    _build.library.cache_clear()
    try:
        with recording() as rec:
            _build.library()
            _build.library()
        assert rec.counters == {"kernel_library.built": 1}
        assert [(s.name, s.parent) for s in rec.spans] == [("kernel_library", None)]
        _build.library.cache_clear()  # a later process loads what is built
        with recording() as rec:
            _build.library()
        assert rec.counters == {}
        assert [s.name for s in rec.spans] == ["kernel_library"]
    finally:
        _build.library.cache_clear()


@pytest.mark.parametrize("what", ["oneshot", "train_step"])
def test_spans_in_the_profilers_trace(models, what, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    _run(models, what)
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as rec:
        _run(models, what)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("span:")]
    assert sorted(e["name"] for e in ranges) == sorted(f"span:{s.name}" for s in rec.spans)
    assert len({e["tid"] for e in ranges}) == 1  # the calling thread's
    by_name = {e["name"]: e for e in ranges}
    outer = by_name["span:" + rec.spans[-1].name]
    for e in ranges:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("cli", ["train", "train_sem"])
def test_profile_dir_trace_holds_the_step_spans(cli, tmp_path, monkeypatch):
    # --profile_dir of both training entry points, its window moved to the
    # first two steps: the trace holds each step's spans and the model's
    import importlib

    module = importlib.import_module(f"omnifusion_torch.cli.{cli}")
    monkeypatch.setattr(module, "PROFILE_STEPS", (0, 1))
    argv = ["--dataset", "synthetic", "--device", "cpu", "--erp_size", "64,128",
            "--patchsize", "32", "--workers", "1", "--epochs", "1", "--seed", "0",
            "--save_path", str(tmp_path / "run"), "--profile_dir", str(tmp_path / "prof")]
    argv += (["--batch", "1", "--synthetic_size", "3"] if cli == "train"
             else ["--batch", "16", "--num_classes", "4"])
    module.main(argv)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation"
                                and e["name"].startswith("span:"))
    steps = {"span:train_step", "span:forward", "span:loss", "span:backward", "span:optimizer"}
    assert {n: names[n] for n in steps} == {n: 2 for n in steps}  # steps 0 and 1, not 2
    assert {n: names[f"span:{n}"] for n in ("model", "e2p", "merge")} == {
        "model": 2, "e2p": 2, "merge": 2}


def _range(name, tid, ts, dur):
    return {"cat": "user_annotation", "name": f"span:{name}", "tid": tid, "ts": ts, "dur": dur}


def _launch(tid, ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"cat": "kernel", "name": name, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_split_trace_attributes_launches_and_names_idle_gaps(tmp_path):
    # a step on thread 1 (µs): the encoder's kernel, one that autograd's
    # thread 2 launches inside the backward (where thread 2's own encoder
    # range, a recompute, does not count), and one from the optimizer
    from omnifusion_torch.tools.profile_forward import OUTSIDE, split_trace

    events = [
        _range("train_step", 1, 0, 100), _range("forward", 1, 0, 30), _range("model", 1, 1, 28),
        _range("encoder", 1, 2, 8), _range("backward", 1, 40, 40), _range("optimizer", 1, 80, 20),
        _range("encoder", 2, 45, 10),
        _launch(1, 5, 1), _kernel("conv", 5, 10, 1),
        _launch(2, 50, 2), _kernel("conv_backward", 50, 10, 2),
        _launch(1, 85, 3), _kernel("adam", 90, 5, 3), _launch(1, 86, 4), _kernel("adam", 97, 8, 4),
        _kernel("memcpy_without_launch", 120, 4, 99),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    split = split_trace(str(path), "train_step")
    assert split["by_kernel"] == pytest.approx(
        {"conv": 0.010, "conv_backward": 0.010, "adam": 0.013, "memcpy_without_launch": 0.004})
    assert split["by_span"] == pytest.approx(  # inclusive: each range open at the launch
        {"train_step": 0.033, "forward": 0.010, "model": 0.010, "encoder": 0.010,
         "backward": 0.010, "optimizer": 0.013})
    assert split["by_span_kernel"]["train_step"] == pytest.approx(  # and by kernel in each
        {"conv": 0.010, "conv_backward": 0.010, "adam": 0.013})
    assert split["by_span_kernel"]["optimizer"] == pytest.approx({"adam": 0.013})
    # idle from 15 (the model open, its encoder closed), 60 (the backward),
    # 95 (the optimizer) and 105 (the step ended)
    assert split["idle_by_span"] == pytest.approx(
        {"model": 0.035, "backward": 0.030, "optimizer": 0.002, OUTSIDE: 0.015})
    assert split["busy_ms"] == pytest.approx(0.037)
    assert split["device_window_ms"] == pytest.approx(0.119)
    with pytest.raises(RuntimeError, match="no span:heads"):  # no stepping thread
        split_trace(str(path), "heads")


def test_profile_forward_host_windows(capsys):
    # the iterative model's forwards in four host windows of one forward
    # each (spans off, on, on, off), then the traced ones
    from omnifusion_torch.tools import profile_forward

    result = profile_forward.run(profile_forward.build_parser().parse_args(
        ["--device", "cpu", "--erp_size", "64,128", "--patchsize", "32", "--batch", "1",
         "--model", "iterative", "--reps", "1", "--host_reps", "1"]))
    assert "== host time by stage, forward (spans on, no profiler)" in capsys.readouterr().out
    assert result["model"] == "iterative" and result["runs"] == 1 + 4 + 1
    host = result["host_window"]
    assert len(host["windows_ms"]) == 4 and all(ms > 0 for ms in host["windows_ms"])
    assert host["ms_per_rep_spans_on"] == pytest.approx(sum(host["windows_ms"][1:3]) / 2)
    stages = {s["name"] for s in result["host_stages"]}
    assert stages == set(STAGES)  # each pass's, summed by name
