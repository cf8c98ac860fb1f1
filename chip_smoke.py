#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from omnifusion_torch/csrc/ (one nvcc per
source, started together), launches the toolchain probe, holds each kernel
against its plain PyTorch version at the shapes the main paths give it (f32
and the bf16 recipe's dtypes), then drives the paths at the flagship config
(512x1024 ERP, patch 128, fov 80, nrows 4, seeded random weights):

- serving: a few panoramas through omnifusion_torch.cli.infer.run_infer in
  f32, checked against the same forward with the plain versions on the card
  and against the CPU at a small size; then with --bf16 --merge_dtype f16
  (the serving recipe), held against the plain versions and the f32 forward;
- training: a few steps at batch 8, a validation pass and a checkpoint
  through omnifusion_torch.cli.train.run_training, and one train step
  checked against the same step with every kernel and backward on its plain
  version, and against the CPU at a small size;
- the measurement entry points, each in this process and each with its
  kernel launches counted: omnifusion_torch/bench.py at batches 2, 8, 64
  and 256 (its batch-2 and batch-8 runs are the bf16 rows of the forward
  timings), the merge shootout (omnifusion_torch/tools/bench_merge.py,
  which launches the probe first), the component times
  (omnifusion_torch/tools/bench_components.py), the profiler
  (omnifusion_torch/tools/profile_forward.py) and the quad_spread and up2x
  times (omnifusion_torch/tools/bench_kernels.py).

Then it times each kernel beside its bound, its plain version and one
library call that computes the same function (quad_spread also split into
its light and heavy launches by the profiler, and swept over the heavy
threshold), and the forward (f32, TF32, bf16 recipe) and the train step end
to end.

Prints one JSON object per phase, then the card's name and power limit as
nvidia-smi gives them, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no last
line; so does a machine without a CUDA device, or a directory without the
repository beside this file.

Precision: f32 convolutions and matmuls are pinned to full f32
(cudnn.allow_tf32 = False, matmul precision "highest") for every phase
except the timings labelled tf32; the bf16 recipe's convolutions are bf16.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
ERP, PATCH, FOV, NROWS = (512, 1024), 128, 80.0, 4
SMALL_ERP, SMALL_PATCH = (64, 128), 32
BATCH, N_PANOS, TIMED_BATCHES = 2, 4, (2, 8)
TRAIN_BATCH, TRAIN_STEPS = 8, 3
BENCH_BATCHES, MERGE_BATCH, PROFILE_BATCH = (8, 64, 256), 64, 8  # bench_components: PROFILE_BATCH
BLEND_TOL = 2e-6  # inputs in [0, 1), weights summing to <= 1: f32 rounding of a 4*K-term sum
UP2X_TOL = 1e-6  # inputs in [0, 1): f32 rounding of a 4-tap (adjoint: 16-tap) stencil
# a bf16 result: the kernel and the plain version both compute in f32 and
# round once to bf16, so they differ by at most one bf16 ulp (2^-7 relative)
UP2X_BF16_RTOL = 2.0**-7
# serve_bf16. At the flagship (full depth, random weights) bf16 rounding
# alone moves the depth far from the f32 forward: the JAX package's own
# recipe puts 24% of the pixels above 0.05 at full depth (256x512, tamed
# heads; tests/test_torch_port_bf16.py::test_bf16_recipe_at_full_depth), so
# there the kernels' distance from f32 is held to BF16_RATIO times the plain
# versions' (median, 99.9%, and that share plus BF16_SHARE). At the
# configuration of the CPU tests' bf16 witness (256x512/p128, depth 2,
# one-block stages) the distance follows the weights' draw: one draw keeps
# the JAX package's recipe near the tests' witness, another puts a tenth of
# the pixels above 0.05 (test_bf16_witness_follows_the_weights). So there the card's recipe
# is held to BF16_RATIO_CPU times the CPU's distance with the same weights
# and input (the CPU recipe that the tests hold to the JAX package's), in
# median and 99.9%, and its share above 0.05 to BF16_RATIO_CPU times the
# CPU's plus BF16_SHARE. The guard of the kernels themselves is the bf16
# checks of each kernel against its plain version (the check phase)
BF16_RATIO, BF16_RATIO_CPU, BF16_SHARE = 1.5, 2.0, 1e-4
WITNESS_ERP, WITNESS_DEPTH = (256, 512), 2
WITNESS_STAGES = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
# quad_spread's time rows: the heavy threshold T and the load above which a
# heavy pixel takes a whole block, swept
HEAVY_SWEEP, WIDE_SWEEP = (16, 32, 64), (128, 256, 512)
# inputs in [0, 1): f32 sums of up to 2194 products per pixel (the merge's
# longest overflow load), summed in another order by the plain version, whose
# index_add_ order changes from run to run: rtol 2194 * 2^-24 = 1.3e-4;
# 16-bit results: one rounding more. The synthetic table with a 5,000-entry
# segment is held to its float64 plain version at the f32 tolerance: the
# heavy kernel's block sums each thread's share of 5000 / 256 terms, then a
# tree
SPREAD_TOL = {torch.float32: (1e-5, 1.3e-4), torch.float16: (1e-5, 1e-3),
              torch.bfloat16: (1e-5, 8e-3)}  # (atol, rtol)
# train parity (step_parity), heads tamed (tame_heads): the loss to f32
# rounding. The f32 gradients of the BatchNorms' parameters are sums that
# nearly cancel: one ulp moved at half of the input's values moves the plain
# path's gradients by up to 8e-3 (relative L2 per tensor) at the flagship,
# batch 8, so no f32 path can hold every tensor to a fixed 1e-3. Each
# tensor is held to witnesses from the same run instead: the distance from
# a float64 run at most F64_RATIO times the larger of the reference path's
# and the reference's own move under that nudge (largest and median), and
# the largest difference at most ULP_RATIO times that move; with the
# BatchNorms on running statistics the median is also held to GRAD_TOL
LOSS_TOL, GRAD_TOL, F64_RATIO, ULP_RATIO = 1e-5, 1e-3, 1.5, 2.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def pin_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def plain_versions():
    """Route every kernel launch of the main paths, forward and backward, to
    the kernel's plain version, on the card; the autograd Functions stay, so
    autograd still never differentiates the plain code. Only this script
    does this, to compare the whole forward and train step."""
    import omnifusion_torch.ops.quad_blend as qb
    import omnifusion_torch.ops.upsample as ups

    saved = qb._blend_kernel, qb._spread_kernel, ups._up2x_kernel, ups._adjoint_kernel
    qb._blend_kernel, qb._spread_kernel = qb.quad_blend_plain, qb.quad_spread_plain
    ups._up2x_kernel, ups._adjoint_kernel = ups.up2x_plain, ups.up2x_adjoint_plain
    try:
        yield
    finally:
        qb._blend_kernel, qb._spread_kernel, ups._up2x_kernel, ups._adjoint_kernel = saved


@contextlib.contextmanager
def deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def run_tool(main, argv: list[str]) -> list[str]:
    """Run an entry point's ``main(argv)`` in this process; its stdout lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def spread_matrix(t):
    """The transposed map W^T as a CSR (N_in, N_out) matrix, built from the
    transposed tables, for torch.sparse.mm."""
    from omnifusion_torch.utils.profiling import sparse_csr

    n_in, w = t.n_in, t.row_stride
    rows = [torch.arange(n_in, device=t.idx_t.device).repeat_interleave(t.k_t)]
    cols = [t.idx_t.long().reshape(-1)]
    vals = [t.w_t.reshape(-1, 4)]
    if t.n_over:
        rows.append(t.over_dst.long())
        cols.append(t.over_src.long())
        vals.append(t.over_w)
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    # corner q of the quad keyed at j is source pixel (j + off_q) mod N_in
    return sparse_csr(
        torch.cat([(r + off) % n_in for off in (0, 1, w, w + 1)]),
        torch.cat([c] * 4),
        torch.cat([v[:, q] for q in range(4)]),
        (n_in, t.n_out),
    )


def check(kernel, case, got, want, atol, rtol=0.0, chunk=None, **extra) -> float:
    """Hold ``got`` to ``want`` within atol + rtol * |want|. ``want`` is a
    tensor or, for a result too large to hold beside its plain version, a
    function of a slice of dim 0, called ``chunk`` rows at a time."""
    torch.cuda.synchronize()
    step = chunk or got.shape[0]
    err, ok = 0.0, True
    for i in range(0, got.shape[0], step):
        rows = slice(i, i + step)
        w = (want(rows) if callable(want) else want[rows]).float()
        e = (got[rows].float() - w).abs()
        ok = ok and bool((e <= atol + rtol * w.abs()).all())
        err = max(err, e.max().item())
    emit({"phase": "check", "kernel": kernel, "case": case, "shape": list(got.shape),
          "dtype": str(got.dtype), "max_abs_err": err, "atol": atol, "rtol": rtol, **extra})
    if not ok:
        raise AssertionError(f"{kernel} {case}: max abs err {err} over tolerance")
    return err


def rel_stats(ours: np.ndarray, ref: np.ndarray) -> dict:
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-3)
    live = np.abs(ref) > 1e-3
    return {
        "median_rel": float(np.median(rel)),
        "q999_rel": float(np.quantile(rel, 0.999)),
        "frac_rel_gt_0.05": float((rel > 0.05).mean()),
        "live_frac": float(live.mean()),
        "median_rel_live": float(np.median(rel[live])) if live.any() else None,
        "max_abs": float(np.abs(ours - ref).max()),
    }


def assert_parity(stats: dict, what: str) -> None:
    # the bounds of the JAX package's upstream parity test
    # (tests/test_reference_parity.py:85-87)
    if not (stats["median_rel"] < 1e-3 and stats["q999_rel"] < 0.05
            and stats["frac_rel_gt_0.05"] < 1e-4):
        raise AssertionError(f"{what}: {stats}")


def _wrappers() -> dict:
    from omnifusion_torch.ops.probe import probe
    from omnifusion_torch.ops.quad_blend import quad_blend, quad_spread
    from omnifusion_torch.ops.upsample import up2x, up2x_adjoint

    return {"quad_blend": quad_blend, "up2x": up2x, "quad_spread": quad_spread,
            "up2x_adjoint": up2x_adjoint, "probe": probe}


def counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def per_run(forwards: int, steps: int = 0) -> dict:
    """The launches of ``forwards`` forwards and ``steps`` train steps (each
    step one forward more, and its backward)."""
    fwd = forwards + steps
    return {"quad_blend": 2 * fwd, "up2x": 5 * fwd, "quad_spread": steps,
            "up2x_adjoint": 5 * steps, "probe": 0}


def straddling_tables(threshold: int, row_stride: int = 128, rows: int = 512,
                      n_out: int = 65536):
    """Transposed tables (K_T = 1) whose overflow loads straddle
    ``threshold``: isolated segments of threshold - 1, threshold, threshold
    + 1 and 5,000 entries (each the whole load of its quad's four pixels),
    one on the last pixel (its corners wrap onto the first), and short
    segments over the first half. Returns the tables and {pixel: load} of
    the isolated segments' pixels."""
    from omnifusion_torch.projection.spec import TransposedTables

    rng = np.random.default_rng(11)
    n_in = row_stride * rows
    seg = np.zeros(n_in, np.int64)
    small = rng.choice(n_in // 2, size=n_in // 8, replace=False)
    seg[small] = rng.integers(1, 4, size=small.size)
    loads = {}
    for k, n in enumerate((threshold - 1, threshold, threshold + 1, 5000)):
        j = n_in // 2 + (4 * k + 1) * row_stride + 5
        seg[j] = n
        loads.update({j + off: n for off in (0, 1, row_stride, row_stride + 1)})
    seg[n_in - 1] = 2 * threshold
    m = int(seg.sum())
    w_t = rng.random((n_in, 1, 4), dtype=np.float32)
    w_t[rng.random(n_in) < 0.3] = 0.0
    t = TransposedTables(
        idx_t=rng.integers(0, n_out, size=(n_in, 1)).astype(np.int32), w_t=w_t,
        over_src=rng.integers(0, n_out, size=m).astype(np.int32),
        over_dst=np.repeat(np.arange(n_in), seg).astype(np.int32),
        over_w=rng.random((m, 4), dtype=np.float32),
        over_ptr=np.concatenate([[0], np.cumsum(seg)]).astype(np.int32),
    )
    return t, loads


def kernel_split_ms(fn, names: tuple, iters: int = 20) -> dict:
    """Device ms per call of ``fn()`` of each kernel whose name holds one of
    ``names``, from torch.profiler's CUDA activity (warm)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                out[n] += getattr(e, "device_time_total", 0.0) / 1e3 / iters
    return out


def zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def synthetic_batch(spec, b: int, device) -> dict:
    from omnifusion_torch.data import SyntheticDataset

    ds = SyntheticDataset(b, spec.erp_h, spec.erp_w, seed=0)
    cols = zip(*(ds[i] for i in range(b)))
    return {k: torch.from_numpy(np.stack(c)).to(device) for k, c in zip(("rgb", "depth", "mask"), cols)}


def tame_heads(state_dict) -> dict:
    """Random weights saturate the heads: most of the ReLU depth is 0 and
    takes no gradient, and the sigmoid confidence is 1, so the merge's
    weighting takes none either. Scaling both head kernels and offsetting
    the depth bias keeps both heads in their live range, so that the whole
    backward of the merge is exercised, as in the CPU tests
    (tests/test_torch_port_train.py)."""
    sd = dict(state_dict)
    for head in ("pred", "weight_pred"):
        sd[f"{head}.weight"] = sd[f"{head}.weight"] * 0.05
    sd["pred.bias"] = sd["pred.bias"] + 2.0
    return sd


def nudged(batch: dict, seed: int) -> dict:
    """``batch`` with its rgb moved up by one ulp at a random half of its
    values: a witness of how far f32 rounding alone moves a train step."""
    rgb = batch["rgb"]
    g = torch.Generator(device=rgb.device).manual_seed(seed)
    pick = torch.rand(rgb.shape, device=rgb.device, generator=g) < 0.5
    return dict(batch, rgb=torch.where(pick, torch.nextafter(rgb, rgb + 1), rgb))


def as_f64(model, batch: dict, state_dict: dict):
    """The arguments of loss_and_grads in float64 (the model in place)."""
    model = model.double()
    model.geo = model.geo.double()
    return (model, {k: v.double() for k, v in batch.items()},
            {k: v.double() if v.is_floating_point() else v for k, v in state_dict.items()})


def loss_and_grads(model, batch, state_dict, train: bool = True) -> tuple[float, dict]:
    """One forward, BerHu loss and backward from ``state_dict``: in train
    mode (the train step's), or with the BatchNorms on the running
    statistics of ``state_dict``."""
    from omnifusion_torch.losses import berhu_loss
    from omnifusion_torch.training import forward_loss

    model.load_state_dict(state_dict)
    model.zero_grad(set_to_none=True)
    if train:
        loss, _ = forward_loss(model, batch)
    else:
        loss = berhu_loss(model.eval()(batch["rgb"]), batch["depth"], batch["mask"])
    loss.backward()
    return loss.item(), {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def grad_parity(a, b) -> dict:
    (la, ga), (lb, gb) = a, b
    rels = {n: float((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)) for n in gb}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    return {"loss": la, "loss_ref": lb, "loss_rel": abs(la / lb - 1),
            "grad_rel_max": max(rels.values()), "grad_rel_median": float(np.median(list(rels.values()))),
            "grad_rel_worst": worst, "tensors": len(rels)}


def step_parity(ours, ref, f64, ref_nudged) -> tuple[dict, bool]:
    """``ours`` against ``ref`` (loss_and_grads results) with the witnesses
    of the tolerance comment: ``f64``, the same step in float64, and
    ``ref_nudged``, ``ref`` on the nudged batch. Returns the numbers and
    whether they hold."""
    par, near, far = grad_parity(ours, ref), grad_parity(ours, f64), grad_parity(ref, f64)
    wit = grad_parity(ref, ref_nudged)
    out = {**par, "ours_vs_f64": near, "ref_vs_f64": far, "ref_vs_ref_nudged": wit}
    # ref may land nearer float64 than its own move under the nudge (an
    # order of sums that happens to round well): then that move is the scale
    ok = (par["loss_rel"] < LOSS_TOL
          and all(near[k] <= F64_RATIO * max(far[k], wit[k])
                  for k in ("grad_rel_max", "grad_rel_median"))
          and par["grad_rel_max"] <= ULP_RATIO * wit["grad_rel_max"])
    return out, ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from omnifusion_torch import bench
    from omnifusion_torch.cli import infer, train
    from omnifusion_torch.models import SphericalFusion, init_weights
    from omnifusion_torch.ops import _build
    from omnifusion_torch.ops.probe import probe, probe_plain
    from omnifusion_torch.ops.quad_blend import (
        HEAVY_THRESHOLD, WIDE_LOAD, BlendTables, SpreadTables, heavy_pixels, overflow_load,
        quad_blend, quad_blend_plain, quad_spread, quad_spread_plain,
    )
    from omnifusion_torch.ops.upsample import up2x, up2x_adjoint, up2x_adjoint_plain, up2x_plain
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
    from omnifusion_torch.projection.spec import build_vjp_tables
    from omnifusion_torch.tools import bench_components, bench_kernels, bench_merge, profile_forward
    from omnifusion_torch.training import create_train_state, train_step
    from omnifusion_torch.utils.profiling import (
        blend_bound, blend_matrix, bound_ms as bound, gpu_line, nbytes, time_ms,
    )

    dev = torch.device(DEVICE)
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "gpu": gpu, "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    pin_f32()

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [os.path.relpath(s, REPO) for s in _build.sources()],
          "library": os.path.relpath(_build.build(), REPO)})

    def timer(fn, iters: int = 20, warmup: int = 3) -> float:
        return time_ms(fn, dev, iters, warmup)

    # ---- the toolchain probe: 2 * x, bit for bit ----
    g = torch.Generator(device=dev).manual_seed(0)
    x_probe = torch.randn(256, 128, device=dev, generator=g) * 1e3
    got = probe(x_probe)
    torch.cuda.synchronize()
    probe_err = (got - probe_plain(x_probe)).abs().max().item()
    if not torch.equal(got, probe_plain(x_probe)):
        raise AssertionError(f"probe: the kernel's 2 * x differs from the plain version's "
                             f"by up to {probe_err}")
    p_bound, p_by = bound(nbytes(x_probe, got), x_probe.numel())
    probe_row = {"shape": [256, 128], "max_abs_err": probe_err, "ms": timer(lambda: probe(x_probe)),
                 "plain_ms": timer(lambda: probe_plain(x_probe)),
                 "library_ms": timer(lambda: torch.mul(x_probe, 2)),
                 "bound_ms": p_bound, "bound_by": p_by}
    emit({"phase": "probe", "bitwise_equal": True, "gpu": gpu, **probe_row})

    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    t0 = time.perf_counter()
    t_e2p, t_p2e = equi2pers_tables(spec, dev), pers2equi_tables(spec, dev)
    seg = t_p2e.vjp.over_ptr.diff()
    emit({"phase": "tables", "seconds": time.perf_counter() - t0,
          "e2p": {"n_out": t_e2p.n_out, "k": t_e2p.k, "n_in": t_e2p.n_in,
                  "k_t": t_e2p.vjp.k_t, "overflow": t_e2p.vjp.n_over},
          "merge": {"n_out": t_p2e.n_out, "k": t_p2e.k, "n_in": t_p2e.n_in,
                    "tail_entries": t_p2e.n_tail, "k_t": t_p2e.vjp.k_t,
                    "overflow": t_p2e.vjp.n_over,
                    "max_overflow_per_pixel": int(seg.max().item()),
                    # quad_spread walks the segments of a pixel's four corners
                    "max_overflow_load": int(overflow_load(
                        t_p2e.vjp.over_ptr.cpu().numpy(), PATCH).max()),
                    "heavy_threshold": t_p2e.vjp.threshold,
                    "heavy_pixels": t_p2e.vjp.heavy.numel()}})

    # ---- each kernel against its plain version, at the paths' shapes ----
    n_erp = ERP[0] * ERP[1]
    errs = {k: 0.0 for k in ("quad_blend", "up2x", "quad_spread", "up2x_adjoint")}  # f32 results

    def note(name, err):
        errs[name] = max(errs[name], err)

    x_e2p = torch.rand(BATCH, n_erp, 3, device=dev, generator=g)
    x_merge = torch.rand(BATCH, 2, t_p2e.n_in, device=dev, generator=g)
    for case, x, tables, cl in (("e2p", x_e2p, t_e2p, True), ("merge_f32", x_merge, t_p2e, False),
                                ("e2p_bf16", x_e2p.bfloat16(), t_e2p, True),
                                ("merge_f16", x_merge.half(), t_p2e, False),
                                ("merge_bf16", x_merge.bfloat16(), t_p2e, False)):
        note("quad_blend", check("quad_blend", case, quad_blend(x, tables, channel_last=cl),
                                 quad_blend_plain(x, tables, channel_last=cl), BLEND_TOL,
                                 tail_entries=tables.n_tail))
    # corners past the end of the source, with weight: they must wrap modulo
    # N_in, as the JAX roll does (a direct read there is an illegal address)
    rng = np.random.default_rng(0)
    n_out = 8192
    wrap_idx = rng.integers(n_erp - 2 * ERP[1], n_erp, size=(n_out, 2)).astype(np.int32)
    wrap_w4 = rng.random((n_out, 2, 4)).astype(np.float32) / 8
    wrap = BlendTables.create(
        wrap_idx, wrap_w4, ERP[1], n_erp, dev,
        tail_ptr=np.arange(n_out + 1, dtype=np.int32),
        tail_pix=np.arange(n_out, dtype=np.int32),
        tail_idx=np.full(n_out, n_erp - 1, np.int32),
        tail_w=rng.random((n_out, 4)).astype(np.float32) / 8,
        vjp=build_vjp_tables(wrap_idx, wrap_w4, n_erp),
    )
    x_wrap = torch.rand(BATCH, 3, n_erp, device=dev, generator=g)
    note("quad_blend", check("quad_blend", "wrapped_corners", quad_blend(x_wrap, wrap),
                             quad_blend_plain(x_wrap, wrap), BLEND_TOL, tail_entries=wrap.n_tail))

    # the transposed blend: the merge's backward at batch 8 (f32 cotangent;
    # 16-bit cotangents), equi2pers's backward, wrapped corners, and the
    # gradient of 16-bit merges, which comes back in the source's dtype
    cot_merge = torch.rand(TRAIN_BATCH, 2, n_erp, device=dev, generator=g)
    cot_e2p = torch.rand(TRAIN_BATCH, t_e2p.n_out, 3, device=dev, generator=g)
    for case, cot, tables, cl in (
        ("merge_f32", cot_merge, t_p2e.vjp, False),
        ("merge_f16_cot", cot_merge.half(), t_p2e.vjp, False),
        ("merge_bf16_cot", cot_merge.bfloat16(), t_p2e.vjp, False),
        ("e2p", cot_e2p, t_e2p.vjp, True),
        ("wrapped_corners", torch.rand(BATCH, 3, n_out, device=dev, generator=g), wrap.vjp, False),
    ):
        atol, rtol = SPREAD_TOL[torch.float32]
        note("quad_spread", check("quad_spread", case, quad_spread(cot, tables, channel_last=cl),
                                  quad_spread_plain(cot, tables, channel_last=cl), atol, rtol,
                                  overflow=tables.n_over))
    for dtype in (torch.float16, torch.bfloat16):  # one rounding to 16 bits: not in errs
        src = x_merge.to(dtype).requires_grad_()
        quad_blend(src, t_p2e).backward(cot_merge[:BATCH])
        atol, rtol = SPREAD_TOL[dtype]
        check("quad_spread", f"merge_{str(dtype)[6:]}_grad", src.grad,
              quad_spread_plain(cot_merge[:BATCH], t_p2e.vjp).to(dtype), atol, rtol)
    # loads straddling the heavy threshold, and one past any block's stride;
    # and the same bits from two calls (fixed-order sums, no atomics)
    t_str, loads = straddling_tables(HEAVY_THRESHOLD)
    straddle = SpreadTables.create(t_str, 128, 65536, dev)
    cot_str = torch.rand(TRAIN_BATCH, 2, 65536, device=dev, generator=g)
    got = quad_spread(cot_str, straddle)
    atol, rtol = SPREAD_TOL[torch.float32]
    note("quad_spread", check("quad_spread", "straddling_threshold", got,
                              quad_spread_plain(cot_str.double(), straddle), atol, rtol,
                              loads=sorted(set(loads.values())), heavy=straddle.heavy.numel(),
                              threshold=straddle.threshold))
    for case, cot, tables in (("straddling_threshold", cot_str, straddle),
                              ("merge_f32", cot_merge, t_p2e.vjp)):
        first, second = quad_spread(cot, tables), quad_spread(cot, tables)
        torch.cuda.synchronize()
        same = torch.equal(first, second) and torch.equal(first, quad_spread(cot, tables))
        emit({"phase": "check", "kernel": "quad_spread", "case": f"{case}_run_to_run",
              "calls": 3, "bitwise_equal": same})
        if not same:
            raise AssertionError(f"quad_spread {case}: calls differ")
    del first, second, got

    p = spec.n_patches
    up_shapes = [(c, s) for c, s in ((512, 4), (128, 8), (64, 16), (64, 32), (32, 64))]
    for b in (BATCH, TRAIN_BATCH):
        for c, s in up_shapes + [(3, 1)]:
            shape = (b * p, c, s, s) if s > 1 else (b, c, 1, 1)
            x = torch.rand(shape, device=dev, generator=g)
            note("up2x", check("up2x", "x".join(map(str, shape)), up2x(x), up2x_plain(x), UP2X_TOL))
            if b == TRAIN_BATCH:
                gy = torch.rand(shape[0], c, 2 * shape[2], 2 * shape[3], device=dev, generator=g)
                note("up2x_adjoint", check("up2x_adjoint", "x".join(map(str, shape)),
                                           up2x_adjoint(gy), up2x_adjoint_plain(gy), UP2X_TOL))
    # the bf16 recipe's decoder at batch 2: the first stage reads the f32
    # sum of layer4 and the tokens (its f32 check is above), the rest bf16
    for c, s in up_shapes[1:]:
        x = torch.rand(BATCH * p, c, s, s, device=dev, generator=g).bfloat16()
        check("up2x", "x".join(map(str, x.shape)) + "_bf16", up2x(x), up2x_plain(x), 1e-6,
              UP2X_BF16_RTOL)
    # odd sides and sides that are not powers of two (the stores are then
    # element by element), f32 and bf16
    for shape in ((5, 3, 7, 33), (2, 4, 1, 9)):
        x = torch.rand(shape, device=dev, generator=g)
        note("up2x", check("up2x", "x".join(map(str, shape)), up2x(x), up2x_plain(x), UP2X_TOL,
                           bitwise_equal=torch.equal(up2x(x), up2x_plain(x))))
        check("up2x", "x".join(map(str, shape)) + "_bf16", up2x(x.bfloat16()),
              up2x_plain(x.bfloat16()), 1e-6, UP2X_BF16_RTOL)
    # the recipe at bench.py's largest batch: the blend reads 768 (e2p) and
    # 512 (merge) rows, and the last upsample makes more than 2^31 outputs
    # (csrc/up2x.cu offsets each plane in 64 bits); the plain versions run a
    # slice of the rows at a time
    big = max(BENCH_BATCHES)
    for case, shape, tables, cl, dtype in (
        ("e2p_bf16", (big, n_erp, 3), t_e2p, True, torch.bfloat16),
        ("merge_f16", (big, 2, t_p2e.n_in), t_p2e, False, torch.float16),
    ):
        x = torch.rand(shape, device=dev, generator=g).to(dtype)
        note("quad_blend", check(
            "quad_blend", f"{case}_b{big}", quad_blend(x, tables, channel_last=cl),
            lambda rows: quad_blend_plain(x[rows], tables, channel_last=cl), BLEND_TOL,
            chunk=16, tail_entries=tables.n_tail))
    outputs = []
    for c, s in up_shapes[3:]:
        x = torch.rand(big * p, c, s, s, device=dev, generator=g).bfloat16()
        outputs.append(4 * x.numel())
        check("up2x", "x".join(map(str, x.shape)) + "_bf16", up2x(x),
              lambda rows: up2x_plain(x[rows]), 1e-6, UP2X_BF16_RTOL, chunk=512,
              outputs=outputs[-1])
    if max(outputs) < 2**31:
        raise AssertionError(f"no up2x check reached 2^31 outputs: {outputs}")
    del x
    torch.cuda.empty_cache()

    # ---- serving: panoramas through the entry point ----
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        inputs = os.path.join(tmp, "panos")
        os.makedirs(inputs)
        rng = np.random.default_rng(1)
        frames = [rng.random((*ERP, 3), dtype=np.float32) for _ in range(N_PANOS)]
        for i, f in enumerate(frames):
            np.save(os.path.join(inputs, f"pano{i}.npy"), f)
        argv = ["--input", inputs, "--save_path", os.path.join(tmp, "out"), "--seed", "0",
                "--device", DEVICE,
                "--batch", str(BATCH), "--erp_size", f"{ERP[0]},{ERP[1]}",
                "--patchsize", str(PATCH), "--fov", str(FOV), "--nrows", str(NROWS)]
        args = infer.build_parser().parse_args(argv)
        zero_counts()
        t0 = time.perf_counter()
        written = infer.run_infer(args)
        serve_s = time.perf_counter() - t0
        serve_launches = counts()
        depths = [np.load(w) for w in written]
        # the serving recipe through the same entry point
        args_bf16 = infer.build_parser().parse_args(
            argv + ["--bf16", "--merge_dtype", "f16", "--save_path", os.path.join(tmp, "out_bf16")])
        zero_counts()
        t0 = time.perf_counter()
        written_bf16 = infer.run_infer(args_bf16)
        serve_bf16_s = time.perf_counter() - t0
        serve_bf16_launches = counts()
        depths_bf16 = [np.load(w) for w in written_bf16]
    n_forwards = -(-N_PANOS // BATCH)
    emit({"phase": "serve", "panoramas": len(written), "batch": BATCH, "forwards": n_forwards,
          "seconds_with_model_build": serve_s, "launches": serve_launches})
    per_forward = per_run(n_forwards)
    if serve_launches != per_forward:
        raise AssertionError(f"expected 2 blend and 5 up2x launches per forward: {serve_launches}")
    for d in depths + depths_bf16:
        if d.shape != ERP or not np.isfinite(d).all() or (d < 0).any():
            raise AssertionError(f"bad depth: shape {d.shape}, finite {np.isfinite(d).all()}")

    # the same forward with the plain versions on the card, same weights
    model = infer.build_model(args)
    batch = torch.from_numpy(np.stack(frames[:BATCH])).to(dev)
    with torch.inference_mode(), plain_versions():
        ref = model(batch)[..., 0].cpu().numpy()
    stats = rel_stats(np.stack(depths[:BATCH]), ref)
    emit({"phase": "parity_vs_plain_on_card", "precision": "f32 (tf32 off)", **stats})
    assert_parity(stats, "served depth vs plain forward")

    # the CUDA path against the CPU path (the one the CPU tests hold against
    # JAX), at a small size with the full-depth model and the same seed
    small = ProjectionSpec.create(SMALL_ERP, SMALL_PATCH, (FOV, FOV), NROWS)
    x_small = torch.from_numpy(
        np.random.default_rng(2).random((BATCH, *SMALL_ERP, 3), dtype=np.float32)
    )
    outs = []
    for device in (dev, torch.device("cpu")):
        m = init_weights(SphericalFusion(small, device=device), 0).eval()
        with torch.inference_mode():
            outs.append(m(x_small.to(device))[..., 0].cpu().numpy())
    stats = rel_stats(outs[0], outs[1])
    emit({"phase": "parity_cuda_vs_cpu_small", "erp": list(SMALL_ERP), "patch": SMALL_PATCH,
          **stats})
    assert_parity(stats, "cuda vs cpu at the small size")

    # ---- serve_bf16: the recipe's launches, and its forward held against
    # the same forward on the plain versions and against the f32 forward,
    # heads tamed (tame_heads) so that the depth and the weighting are live ----
    model_bf16 = infer.build_model(args_bf16)
    sd = tame_heads(model.state_dict())
    model.load_state_dict(sd)
    model_bf16.load_state_dict(sd)
    with torch.inference_mode():
        f32 = model(batch)[..., 0].cpu().numpy()
        kern = model_bf16(batch)[..., 0].cpu().numpy()
        with plain_versions():
            plain = model_bf16(batch)[..., 0].cpu().numpy()
    k_stats, p_stats = rel_stats(kern, f32), rel_stats(plain, f32)
    del model, model_bf16
    # the witness's configuration, same seed: f32 and the recipe, on the
    # card (kernels) and on the CPU (plain versions)
    wspec = ProjectionSpec.create(WITNESS_ERP, PATCH, (FOV, FOV), NROWS)
    x_w = torch.from_numpy(
        np.random.default_rng(0).random((BATCH, *WITNESS_ERP, 3), dtype=np.float32))
    w_out = {}
    for device in (dev, torch.device("cpu")):
        for dt, mdt in ((None, None), (torch.bfloat16, torch.float16)):
            m = SphericalFusion(wspec, depth=WITNESS_DEPTH, encoder_stages=WITNESS_STAGES,
                                dtype=dt, merge_dtype=mdt, device=device)
            m.load_state_dict(tame_heads(init_weights(m, 0).state_dict()))
            with torch.inference_mode():
                w_out[device.type, dt] = m.eval()(x_w.to(device))[..., 0].cpu().numpy()
    w_card, w_cpu = (rel_stats(w_out[d, torch.bfloat16], w_out[d, None]) for d in (dev.type, "cpu"))
    emit({"phase": "serve_bf16", "panoramas": len(written_bf16), "batch": BATCH,
          "recipe": "bf16 trunk + f16 merge", "seconds_with_model_build": serve_bf16_s,
          "launches": serve_bf16_launches, "heads": "tamed",
          "kernels_vs_f32": k_stats, "plain_vs_f32": p_stats,
          "kernels_vs_plain": rel_stats(kern, plain), "ratio_bound": BF16_RATIO,
          "witness_config": {"erp": list(WITNESS_ERP), "patch": PATCH, "depth": WITNESS_DEPTH,
                             "stages": "one block each", "card_vs_f32": w_card,
                             "cpu_vs_f32": w_cpu, "ratio_bound": BF16_RATIO_CPU,
                             "share_slack": BF16_SHARE},
          "served_vs_served_f32_untamed": rel_stats(np.stack(depths_bf16), np.stack(depths))})
    if serve_bf16_launches != per_forward:
        raise AssertionError(f"bf16 serve launches {serve_bf16_launches}, expected {per_forward}")
    for key in ("median_rel", "q999_rel", "frac_rel_gt_0.05"):
        slack = BF16_SHARE if key == "frac_rel_gt_0.05" else 0.0
        if not k_stats[key] <= BF16_RATIO * p_stats[key] + slack:
            raise AssertionError(f"bf16 recipe {key}: kernels {k_stats}, plain {p_stats}")
        if not w_card[key] <= BF16_RATIO_CPU * w_cpu[key] + slack:
            raise AssertionError(f"bf16 recipe at the witness configuration {key}: card "
                                 f"{w_card}, cpu {w_cpu}")

    # ---- training: steps, a validation pass and checkpoints through the entry point ----
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        n_train = TRAIN_STEPS * TRAIN_BATCH
        argv = ["--dataset", "synthetic", "--synthetic_size", str(n_train), "--epochs", "1",
                "--batch", str(TRAIN_BATCH), "--erp_size", f"{ERP[0]},{ERP[1]}",
                "--patchsize", str(PATCH), "--fov", str(FOV), "--nrows", str(NROWS),
                "--seed", "0", "--device", DEVICE, "--workers", "4",
                "--save_path", os.path.join(tmp, "run")]
        targs = train.build_parser().parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        history = train.run_training(targs)
        train_s = time.perf_counter() - t0
        train_launches = counts()
        ckpts = sorted(os.listdir(os.path.join(tmp, "run", "ckpt")))
    val_forwards = -(-n_train // TRAIN_BATCH)  # the validation set has --synthetic_size panoramas
    fwd = TRAIN_STEPS + val_forwards
    want = per_run(val_forwards, TRAIN_STEPS)
    emit({"phase": "train", "batch": TRAIN_BATCH, "steps": history["steps"],
          "validation_forwards": val_forwards, "train_loss": history["train_loss"],
          "val": history["val"], "checkpoints": ckpts, "seconds_with_model_build": train_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": train_launches, "launches_expected": want})
    if history["steps"] != TRAIN_STEPS or not np.isfinite(history["train_loss"]).all():
        raise AssertionError(f"train run: {history}")
    if train_launches != want:
        raise AssertionError(f"train launches {train_launches}, expected {want}")
    if ckpts != ["best.pt", "latest.pt"]:
        raise AssertionError(f"checkpoints: {ckpts}")

    # one train step's loss and gradients with every kernel and backward on
    # its plain version, same weights, same batch, same card: in train mode
    # (float64 on the plain versions, which then compute in float64), and
    # with the BatchNorms on the running statistics the train forward left
    tb = synthetic_batch(spec, TRAIN_BATCH, dev)
    tb_nudged = nudged(tb, 5)
    model = init_weights(SphericalFusion(spec, device=dev), 0)
    sd0 = tame_heads(copy.deepcopy(model.state_dict()))
    with deterministic_cudnn():
        kern = loss_and_grads(model, tb, sd0)
        sd1 = copy.deepcopy(model.state_dict())
        kern_rs = loss_and_grads(model, tb, sd1, train=False)
        with plain_versions():
            plain = [loss_and_grads(model, b, sd0) for b in (tb, tb_nudged)]
            plain_rs = [loss_and_grads(model, b, sd1, train=False) for b in (tb, tb_nudged)]
            f64 = loss_and_grads(*as_f64(model, tb, sd0))
            f64_rs = loss_and_grads(*as_f64(model, tb, sd1), train=False)
    del model
    par, ok = step_parity(kern, plain[0], f64, plain[1])
    par_rs, ok_rs = step_parity(kern_rs, plain_rs[0], f64_rs, plain_rs[1])
    emit({"phase": "train_parity_vs_plain_on_card", "batch": TRAIN_BATCH, "heads": "tamed",
          "precision": "f32 (tf32 off), cuDNN deterministic", "loss_tol": LOSS_TOL,
          "f64_ratio": F64_RATIO, "ulp_ratio": ULP_RATIO, "median_tol_running_stats": GRAD_TOL,
          "train_mode": par, "running_stats": par_rs})
    if not (ok and ok_rs and par_rs["grad_rel_median"] < GRAD_TOL):
        raise AssertionError(f"train step vs plain versions: {par}, {par_rs}")
    del kern, kern_rs, plain, plain_rs, f64, f64_rs

    # the same step, CUDA against CPU, at the small size with the full-depth model
    cpu = torch.device("cpu")
    m = init_weights(SphericalFusion(small, device=cpu), 0)
    sd0 = tame_heads(copy.deepcopy(m.state_dict()))
    b = synthetic_batch(small, BATCH, cpu)
    cpu_run = loss_and_grads(m, b, sd0)
    sd1 = copy.deepcopy(m.state_dict())  # the running statistics the CPU's step left
    cpu_rs = loss_and_grads(m, b, sd1, train=False)
    cpu_nudged = loss_and_grads(m, nudged(b, 5), sd0)
    cpu_rs_nudged = loss_and_grads(m, nudged(b, 5), sd1, train=False)
    f64 = loss_and_grads(*as_f64(m, b, sd0))
    f64_rs = loss_and_grads(*as_f64(m, b, sd1), train=False)
    m = init_weights(SphericalFusion(small, device=dev), 0)
    b = synthetic_batch(small, BATCH, dev)
    with deterministic_cudnn():
        cuda_run = loss_and_grads(m, b, {k: v.to(dev) for k, v in sd0.items()})
        cuda_rs = loss_and_grads(m, b, {k: v.to(dev) for k, v in sd1.items()}, train=False)
    par, ok = step_parity(cuda_run, cpu_run, f64, cpu_nudged)
    par_rs, ok_rs = step_parity(cuda_rs, cpu_rs, f64_rs, cpu_rs_nudged)
    emit({"phase": "train_parity_cuda_vs_cpu_small", "erp": list(SMALL_ERP), "patch": SMALL_PATCH,
          "batch": BATCH, "heads": "tamed", "loss_tol": LOSS_TOL, "f64_ratio": F64_RATIO,
          "ulp_ratio": ULP_RATIO, "median_tol_running_stats": GRAD_TOL, "train_mode": par,
          "running_stats": par_rs})
    if not (ok and ok_rs and par_rs["grad_rel_median"] < GRAD_TOL):
        raise AssertionError(f"train step cuda vs cpu: {par}, {par_rs}")
    del m

    # ---- kernel timings: the f32 path's calls (on_path), and the bf16
    # recipe's (recipe "bf16": e2p in bf16, the merge in f16, the decoder's
    # upsamples in bf16 but the first) ----
    rows = {k: [] for k in errs}
    for name, x, tables, cl, recipe in (
        ("e2p", x_e2p, t_e2p, True, None), ("merge_f32", x_merge, t_p2e, False, None),
        ("e2p_bf16", x_e2p.bfloat16(), t_e2p, True, "bf16"),
        ("merge_f16", x_merge.half(), t_p2e, False, "bf16"),
    ):
        out = quad_blend(x, tables, channel_last=cl)
        b_ms, b_by = blend_bound(x, tables, out)
        w_csr = blend_matrix(tables, x.dtype)
        dense = (x.permute(1, 0, 2) if cl else x.permute(2, 0, 1)).reshape(tables.n_in, -1).contiguous()
        lib_out = torch.sparse.mm(w_csr, dense)
        want_out = out.permute(1, 0, 2) if cl else out.permute(2, 0, 1)
        lib_err = (lib_out.float() - want_out.reshape(tables.n_out, -1)).abs().max().item()
        rows["quad_blend"].append({
            "case": name, "shape": list(x.shape), "on_path": recipe is None, "recipe": recipe,
            "ms": timer(lambda: quad_blend(x, tables, channel_last=cl)),
            "plain_ms": timer(lambda: quad_blend_plain(x, tables, channel_last=cl), iters=10),
            "library_ms": timer(lambda: torch.sparse.mm(w_csr, dense)),
            "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
        })
    for name, cot, t, cl, on_path in (("merge_f32_b8", cot_merge, t_p2e.vjp, False, True),
                                      ("e2p_b8", cot_e2p, t_e2p.vjp, True, False)):
        out = quad_spread(cot, t, channel_last=cl)
        n_entries = int((t.w_t.sum(-1) > 0).sum().item()) + t.n_over
        b_ms, b_by = bound(
            nbytes(cot, out, t.idx_t, t.w_t, t.over_ptr, t.over_src, t.over_w),
            8.0 * n_entries * cot.numel() / t.n_out,
        )
        wt_csr = spread_matrix(t)
        dense = (cot.permute(1, 0, 2) if cl else cot.permute(2, 0, 1)).reshape(t.n_out, -1).contiguous()
        lib_out = torch.sparse.mm(wt_csr, dense)
        want_out = (out.permute(1, 0, 2) if cl else out.permute(2, 0, 1)).reshape(t.n_in, -1)
        no_over = SpreadTables(t.idx_t, t.w_t, t.row_stride, t.n_out)
        split = kernel_split_ms(lambda: quad_spread(cot, t, channel_last=cl),
                                ("quad_spread_kernel", "quad_spread_heavy_kernel"))
        sweep = []  # the tables' own T and wide load are the module's constants
        over_ptr = t.over_ptr.cpu().numpy()
        for threshold in HEAVY_SWEEP if on_path else ():
            for wide_load in WIDE_SWEEP:
                heavy, n_wide = heavy_pixels(over_ptr, t.row_stride, threshold, wide_load)
                t_sw = dataclasses.replace(t, threshold=threshold, n_wide=n_wide,
                                           heavy=torch.from_numpy(heavy).to(dev))
                sweep.append({"T": threshold, "wide_load": wide_load, "heavy": len(heavy),
                              "wide": n_wide,
                              "ms": timer(lambda: quad_spread(cot, t_sw, channel_last=cl))})
        rows["quad_spread"].append({
            "case": name, "shape": list(cot.shape), "on_path": on_path, "overflow": t.n_over,
            "T": t.threshold, "wide_load": WIDE_LOAD, "heavy": t.heavy.numel(),
            "wide": t.n_wide,
            "ms": timer(lambda: quad_spread(cot, t, channel_last=cl)),
            "ms_light": split["quad_spread_kernel"], "ms_heavy": split["quad_spread_heavy_kernel"],
            "split_from": "torch.profiler, 20 calls", "sweep": sweep,
            "ms_without_overflow": timer(lambda: quad_spread(cot, no_over, channel_last=cl)),
            "plain_ms": timer(lambda: quad_spread_plain(cot, t, channel_last=cl), iters=5),
            "library_ms": timer(lambda: torch.sparse.mm(wt_csr, dense)),
            "library_max_abs_err": (lib_out - want_out).abs().max().item(),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    for b, recipe in ((BATCH, None), (BATCH, "bf16"), (TRAIN_BATCH, None)):
        for i, (c, s) in enumerate(up_shapes):
            shape = (b * p, c, s, s)
            x = torch.rand(shape, device=dev, generator=g)
            if recipe == "bf16" and i > 0:
                x = x.bfloat16()
            if b == BATCH:
                b_ms, b_by = bound(5 * nbytes(x), 9.0 * 4 * x.numel())
                rows["up2x"].append({
                    "case": "x".join(map(str, shape)) + f"_{str(x.dtype)[6:]}",
                    "shape": list(shape), "on_path": recipe is None, "recipe": recipe,
                    "ms": timer(lambda: up2x(x)),
                    "plain_ms": timer(lambda: up2x_plain(x), iters=10),
                    "library_ms": timer(lambda: torch.nn.functional.interpolate(
                        x, scale_factor=2, mode="bilinear", align_corners=False)),
                    "bound_ms": b_ms, "bound_by": b_by,
                })
            else:
                gy = torch.rand(b * p, c, 2 * s, 2 * s, device=dev, generator=g)
                b_ms, b_by = bound(nbytes(gy) + nbytes(x), 2.0 * 20 * x.numel())
                size = [b * p, c, s, s]
                rows["up2x_adjoint"].append({
                    "case": "x".join(map(str, shape)), "shape": list(gy.shape), "on_path": True,
                    "ms": timer(lambda: up2x_adjoint(gy)),
                    "plain_ms": timer(lambda: up2x_adjoint_plain(gy), iters=10),
                    "library_ms": timer(lambda: torch.ops.aten.upsample_bilinear2d_backward(
                        gy, [2 * s, 2 * s], size, False)),
                    "library_max_abs_err": (torch.ops.aten.upsample_bilinear2d_backward(
                        gy, [2 * s, 2 * s], size, False) - up2x_adjoint(gy)).abs().max().item(),
                    "bound_ms": b_ms, "bound_by": b_by,
                })
    for kernel, rs in rows.items():
        for r in rs:
            emit({"phase": "time", "kernel": kernel, "gpu": gpu, **r})

    # ---- serving throughput of the recipe: bench.py at each batch, in this
    # process, its launches counted ----
    flagship = ["--device", DEVICE, "--erp_size", f"{ERP[0]},{ERP[1]}", "--patchsize", str(PATCH)]
    benches = {}
    for b in sorted(set(TIMED_BATCHES) | set(BENCH_BATCHES)):
        zero_counts()
        lines = run_tool(bench.main, flagship + ["--batch", str(b)])
        launches = counts()
        if len(lines) != 1:
            raise AssertionError(f"bench.py printed {len(lines)} lines: {lines}")
        benches[b] = res = json.loads(lines[0])
        emit({"phase": "bench", **res, "launches": launches})
        if launches != per_run(res["forwards"]):
            raise AssertionError(f"bench.py at batch {b}: launches {launches}, "
                                 f"expected {per_run(res['forwards'])}")
        torch.cuda.empty_cache()

    # ---- end to end: the forward (the bf16 recipe's rows are bench.py's)
    # and the train step ----
    fwd_times = {f"bf16_b{b}": {"device_ms": benches[b]["device_ms"],
                                "wall_ms": benches[b]["wall_ms"],
                                "panos_per_s": benches[b]["value"], "from": "bench.py"}
                 for b in TIMED_BATCHES}
    for label, tf32 in (("f32", False), ("tf32", True)):
        model = infer.build_model(args)
        torch.backends.cudnn.allow_tf32 = tf32
        for b in TIMED_BATCHES:
            x = torch.rand(b, *ERP, 3, device=dev, generator=g)
            with torch.inference_mode():
                ms = timer(lambda: model(x), iters=5, warmup=2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    model(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / 5
            fwd_times[f"{label}_b{b}"] = {"device_ms": ms, "wall_ms": wall_ms,
                                          "panos_per_s": b / (wall_ms / 1e3)}
    pin_f32()
    emit({"phase": "forward", "gpu": gpu, "erp": list(ERP), "patch": PATCH, "fov": FOV,
          "nrows": NROWS, "bf16": "bf16 trunk + f16 merge", **fwd_times})
    del model

    step_times = {}
    state = create_train_state(init_weights(SphericalFusion(spec, device=dev), 0))
    for label, tf32 in (("f32", False), ("tf32", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = timer(lambda: train_step(state, tb), iters=5, warmup=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            train_step(state, tb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5
        step_times[label] = {"device_ms": ms, "wall_ms": wall_ms,
                             "panos_per_s": TRAIN_BATCH / (wall_ms / 1e3)}
    pin_f32()
    emit({"phase": "train_step", "gpu": gpu, "batch": TRAIN_BATCH, "erp": list(ERP),
          "patch": PATCH, **step_times})
    del state
    torch.cuda.empty_cache()

    # ---- the other measurement entry points, each run in this process ----
    zero_counts()
    lines = run_tool(bench_merge.main,
                     flagship + ["--batch", str(MERGE_BATCH), "--dtypes", "f16,bf16,f32"])
    merge_launches = counts()
    if not lines[0].startswith("probe ok on") or merge_launches["probe"] != 1:
        raise AssertionError(f"bench_merge: {lines[:1]}, launches {merge_launches}")
    for line in lines[1:]:
        emit({"phase": "bench_merge", "batch": MERGE_BATCH, **json.loads(line)})
    emit({"phase": "bench_merge", "launches": merge_launches})

    for line in run_tool(bench_components.main, flagship + [
            "--batch", str(PROFILE_BATCH), "--bf16", "--merge_dtype", "f16"]):
        emit({"phase": "bench_components", "gpu": gpu, **json.loads(line)})

    zero_counts()
    res = json.loads(run_tool(bench_kernels.main, ["--iters", "10"])[0])
    launches = counts()
    emit({"phase": "bench_kernels", **res, "launches": launches})
    if not (launches["quad_spread"] > 0 and launches["up2x"] > 0
            and launches["quad_blend"] == launches["up2x_adjoint"] == launches["probe"] == 0):
        raise AssertionError(f"bench_kernels launches {launches}")

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        for argv in (["--bf16", "--merge_dtype", "f16"], ["--train"]):
            zero_counts()
            lines = run_tool(profile_forward.main, flagship + argv + [
                "--batch", str(PROFILE_BATCH), "--top", "10", "--profile_dir", tmp])
            launches = counts()
            res = json.loads(lines[-1])
            want_l = per_run(0, res["runs"]) if "--train" in argv else per_run(res["runs"])
            if launches != want_l:
                raise AssertionError(f"profile {argv}: launches {launches}, expected {want_l}")
            for r in res.get("top_kernels", []):
                r["name"] = r["name"][:120]
            emit({"phase": "profile", "gpu": gpu, "argv": argv, "launches": launches,
                  "precision": "f32 (tf32 off)" if "--train" in argv else "bf16 trunk + f16 merge",
                  **{k: v for k, v in res.items() if k != "trace"}})

    # launches: the training run's count (its steps and validation
    # forwards), and per forward or step; the times: per forward at batch 2
    # (forward kernels) or per train step at batch 8 (backward kernels),
    # summed over the kernel's calls in it
    kernels = []
    for name, source, replaces, per, n_per in (
        ("quad_blend", "omnifusion_torch/csrc/quad_blend.cu",
         "omnifusion_tpu/ops/pallas_blend.py:81", "forward", fwd),
        ("up2x", "omnifusion_torch/csrc/up2x.cu",
         "omnifusion_tpu/ops/pallas_resize.py:46", "forward", fwd),
        ("quad_spread", "omnifusion_torch/csrc/quad_spread.cu",
         "omnifusion_tpu/ops/pallas_blend.py:95", "step", TRAIN_STEPS),
        ("up2x_adjoint", "omnifusion_torch/csrc/up2x.cu",
         "omnifusion_tpu/ops/pallas_resize.py:161 (backward of _up2x_kernel's custom VJP)",
         "step", TRAIN_STEPS),
    ):
        rs = [r for r in rows[name] if r["on_path"]]
        bys = {r["bound_by"] for r in rs}
        recipe = [r for r in rows[name] if r.get("recipe") == "bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[name],
            "launches_of": f"training run: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, "
                           f"{val_forwards} validation forwards",
            f"launches_per_{per}": train_launches[name] / n_per,
            "launches_serve": serve_launches[name],
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if bys == {"bytes"} else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
            "ms_per": "forward at batch 2" if per == "forward" else f"train step at batch {TRAIN_BATCH}",
            **({"ms_bf16_recipe": sum(r["ms"] for r in recipe),
                "bound_ms_bf16_recipe": sum(r["bound_ms"] for r in recipe)} if recipe else {}),
        })
    kernels.append({
        "name": "probe", "route": "cuda", "source": "omnifusion_torch/csrc/probe.cu",
        "replaces": "tools/bench_pallas_merge.py:57", "launches": merge_launches["probe"],
        "launches_of": f"merge shootout (omnifusion_torch/tools/bench_merge.py) at batch {MERGE_BATCH}",
        **{k: probe_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "ms_per": "call on (256, 128) f32", "library": "torch.mul(x, 2)",
    })
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
