#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from omnifusion_torch/csrc/ (one nvcc per
source, started together), launches the toolchain probe, holds each kernel
against its plain PyTorch version at the shapes the main paths give it (f32
and the bf16 recipe's dtypes; the iterative model's quarter-resolution
equi2pers of a 1-channel depth and its channel-last backward; the merge at
nrows 6, fov 90, whose pixels hold more quads than the blend kernel keeps
in registers), then drives the paths at the flagship config (512x1024 ERP,
patch 128, fov 80, nrows 4, seeded random weights):

- serving: a few panoramas through omnifusion_torch.cli.infer.run_infer in
  f32, checked against the same forward with the plain versions on the card
  and against the CPU at a small size; then with --bf16 --merge_dtype f16
  (the serving recipe), held against the plain versions and the f32 forward;
- training: a few steps at batch 8, a validation pass and a checkpoint
  through omnifusion_torch.cli.train.run_training, and one train step
  checked against the same step with every kernel and backward on its plain
  version, and against the CPU at a small size;
- the iterative model (2 passes): serve_iterative serves the panoramas
  through run_infer --model iterative in f32 and the bf16 recipe, held as
  serving and serve_bf16 hold the one-shot model's, every pass;
  train_iterative trains a few steps at batch 8, validates and saves through
  run_training --model iterative, and holds one step against the plain
  versions;
- segmentation (13 classes): serve_seg runs SphericalFusionSeg's forward on
  the panoramas, held against the same forward with the plain versions;
  train_sem trains one epoch at batch 8 (the CLI's fixed 32-panorama
  synthetic set: 4 steps), validates by mIoU and saves through
  omnifusion_torch.cli.train_sem, and one step is held against the plain
  versions; the check phase holds the 14-row merge, its spread, the
  perspective views (omnifusion_torch/projection/perspective.py, forward and
  backward) and the channel-last pers2equi to the plain versions;
- the extras: pano_stretch (omnifusion_torch/ops/pano_stretch.py) forward
  and backward at two (kx, ky), f32 and bf16, through the blend and spread
  kernels on its own tables, each call held to the plain versions and timed
  beside F.grid_sample; the DIBR chain (dibr_vertical, dibr_horizontal, the
  photometric and guided smoothness losses, their backward to the depth, the
  normals, chamfer on 16,384 points per cloud) held to the same chain in
  float64 on the card and, where f32 rounding alone passes a fixed bound
  (the plane-fit normals, the depth gradient), to the CPU's f32 chain;
- the multi-device path (omnifusion_torch/parallel): ddp_gloo2 spawns two
  gloo ranks on the card (nccl refuses two ranks on one device), which
  probe gloo's collectives on CUDA tensors, hold GlobalBatchNorm2d to
  cuDNN's BatchNorm2d on the whole batch, and take one DDP train step of
  each model on their halves of the flagship batch, each held to the
  one-process step (the float64 and one-ulp witnesses, the parameters
  after the step, the running statistics) with the kernels' launches per
  rank; mesh_model spawns gloo ranks on the card on the mesh data 1 x
  model 2 (each model of ddp_gloo2 and a batch-2 eval forward) and data 2
  x model 2 (the one-shot step), each rank running the trunk on its chunk
  of the patch stack (omnifusion_torch/parallel/model_axis.py), held to
  the same one-process references, with the launches per rank; mesh1 runs
  cli.train, cli.train_sem, cli.test and cli.infer with --mesh 1 (a
  one-rank nccl group, DDP and the global BatchNorm for real), and times
  the one-shot train step with it and without a mesh;
- the measurement entry points, each in this process and each with its
  kernel launches counted: omnifusion_torch/bench.py at batches 2, 8, 64
  and 256 (its batch-2 and batch-8 runs are the bf16 rows of the forward
  timings), the merge shootout (omnifusion_torch/tools/bench_merge.py,
  which launches the probe first), the component times
  (omnifusion_torch/tools/bench_components.py), the profiler
  (omnifusion_torch/tools/profile_forward.py) and the quad_blend,
  quad_spread and up2x times (omnifusion_torch/tools/bench_kernels.py);
- the measurement tools, last, each through its main() with its launches
  counted: bench_train (the b8 step and forward with their FLOPs and MFU:
  f32, TF32, the bf16 recipe, the iterative model; the f32 step's FLOPs
  held to the CPU tests' count and its time to the train_step phase's),
  remat (bench_train --remat: its peak memory, and one step held to the
  step without it), bench_sweep (its f16_merge b64 row held to bench.py's
  b64), sol_model --calibrate --train (the card's copy and bf16 matmul
  rates, the floors, each kernel row held to the time phase's bound for
  the same call), eval_merge_dtype (the 16-bit merges in eval metrics) and
  verify_kernels (every check PASS).

The up2x adjoint is held to its plain version bit for bit (f32 and bf16,
every decoder stage at batch 8, odd sides, an unaligned view, and past 2^31
cotangents at batch 256). The fused heads kernel (2 and 14 outputs, f32 and
bf16, at batch 2 and at the batched cells' batch 64, on channels-last maps,
and on a contiguous map through the wrapper's copy) is held within the
bound that f32 sums and bf16 roundings allow between two correct versions
(verify_kernels.heads_gap), and timed beside its bytes' bound and its plain
version (cuDNN's convolution and the activations) on the same map
(heads_phase); the models run it once a pass in every forward that records
no gradients, never in a train step. Where autograd records nothing the
decoder runs channels-last, so up2x's NHWC form (the NCHW form's bits) is
checked and timed at the batch-64 shapes beside its NCHW form, and each
model's forward is asserted to launch only it (channels_last_phase). In
those forwards each convolution and its eval-mode BatchNorm run folded: the
convolution on its cached bf16 weight, then one pass (the epilogue kernel)
applies the BatchNorm's scale and bias, the residual and the ReLU. Each
model's folded forward is held to its unfolded one and counted (47 folded
convolutions a pass, each folded once), the kernel to its plain version's
bits at the b64 maps and timed, and the b64 bf16 forward timed both ways
(fold_phase). The one-shot model at the upstream README's patch 256 gets
the same checks at its own shapes: each kernel against its plain version,
the fold, the up_proj sum in layer4's memory order, the serving forward's
launches and time, and cli/infer.py (p256_phase).

Then it times each kernel beside its bound, its plain version and one
library call that computes the same function (the up2x adjoint also with
the L2 cache flushed before each call; quad_blend also at bench.py's
batches 8, 64 and 256, and swept over its tile shape, its staged rows and
staging itself; quad_spread also split into its light and heavy launches by
the profiler, and swept over the heavy threshold; the iterative model's
calls, the nrows 6 merge, the segmentation merge and the perspective views
too), and the forward (f32, TF32, bf16 recipe) and the train step end to
end, of the three models.

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

import argparse
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
sys.path.insert(0, REPO)
# the tolerances and the parity helpers that omnifusion_torch.tools.verify_kernels
# shares with this script (a directory without the repository fails here)
from omnifusion_torch.tools.verify_kernels import (  # noqa: E402
    BLEND_TOL, F64_RATIO, FOLD_BF16_RATIO, FOLD_F32_GAP, GRAD_TOL, HEAD_SCALE, LOSS_TOL,
    SPREAD_TOL, ULP_RATIO, UP2X_BF16_RTOL, UP2X_TOL, as_f64, calibrate_norms, compare,
    grad_parity, heads_gap, heads_params, loss_and_grads, nudged, plain_versions, step_parity,
    tame_heads,
)

DEVICE = "cuda"
ERP, PATCH, FOV, NROWS = (512, 1024), 128, 80.0, 4
SMALL_ERP, SMALL_PATCH = (64, 128), 32
BATCH, N_PANOS, TIMED_BATCHES = 2, 4, (2, 8)
TRAIN_BATCH, TRAIN_STEPS = 8, 3
BENCH_BATCHES, MERGE_BATCH, PROFILE_BATCH = (8, 64, 256), 64, 8  # bench_components: PROFILE_BATCH
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
# the iterative model: passes; the quarter-resolution equi2pers's batches in
# the check phase; the merge whose pixels hold more quads than the blend
# kernel keeps in registers (9 at 512x1024, patch 128)
ITERS, E2P_Q_BATCHES = 2, (2, 8, 64)
# serve_iterative's bf16 statistics pool the batch and copies of it moved
# by one bf16 ulp at a random half of its values, one per seed
BF16_NUDGES = (5, 6, 7)
N6_FOV, N6_NROWS = 90.0, 6
WITNESS_STAGES = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
# quad_spread's time rows: the heavy threshold T and the load above which a
# heavy pixel takes a whole block, swept
HEAVY_SWEEP, WIDE_SWEEP = (16, 32, 64), (128, 256, 512)
# quad_blend's sweep: output tiles (rows, columns); staged, with R source
# rows staged per step; or gathered from global memory, with the source rows
# a block takes (None: all)
TILE_SWEEP, CHUNK_SWEEP, UNIT_SWEEP = ((8, 32), (4, 64), (4, 32), (16, 32)), (8, 16, 32), (24, None)
BLEND_ROWS = (1, 3, 130)  # row counts no staged chunk divides
# the synthetic table with a 5,000-entry segment is held to its float64
# plain version at quad_spread's f32 tolerance (SPREAD_TOL): the heavy
# kernel's block sums each thread's share of 5000 / 256 terms, then a tree
# eval: panoramas per run (2 batches); each metric of the kernels' run within
# EVAL_TOL (relative, at least absolute) of the plain versions' and of the
# CPU's. train_bf16: the bf16 step's loss within BF16_LOSS_TOL of the plain
# versions' (its gradients as step_parity holds the f32 steps, with a float64
# run of the same weights and a one-bf16-ulp nudge of the input as witnesses)
EVAL_PANOS, EVAL_TOL, BF16_LOSS_TOL = 4, 1e-4, 1e-3
# the small eval's head scale (tame_heads): at 64x128 the default 0.05 leaves
# a quarter (one-shot) and a tenth (iterative) of the depth at the ReLU's
# edge, below 1e-3, where log_rms_sq's log magnifies the f32 rounding of the
# card against the CPU's (a gap of 1.2e-4 there); 0.01 keeps every pixel
# live. The flagship eval keeps the default, as serve_iterative does
SMALL_EVAL_HEAD_SCALE = 0.01
# eval_rate: panoramas per rate run (EVAL_RATE_PANOS / BATCH batches, the
# rate taken after the first) and rate runs per model, for the spread
EVAL_RATE_PANOS, EVAL_RATE_RUNS = 64, 3
# segmentation: classes (the merge blends SEG_CLASSES + 1 rows per
# panorama); cli.train_sem's fixed synthetic sets (32 to train, 8 to
# validate); the train-parity batch
SEG_CLASSES, SEM_TRAIN_SET, SEM_VAL_SET, SEM_PARITY_BATCH = 13, 32, 8, 8
# the perspective views: 8 views of 256x256 at a 90 degree field of view
# (the seam from both sides, near both poles, the equator), timed at batch
# 2 with 3 channels; and 2 views at 120 degrees near the north pole and on
# the seam, the widest footprints of the blend's tiles
VIEW_CENTERS = ((0.5, 0.0), (90.0, 20.0), (180.0, 0.0), (270.0, -20.0), (359.5, 45.0),
                (45.0, 88.0), (135.0, -88.0), (225.0, -45.0))
VIEW_FOV, VIEW_SIZE = (90.0, 90.0), (256, 256)
WIDE_VIEW_CENTERS, WIDE_VIEW_FOV = ((0.0, 89.0), (359.9, 0.0)), (120.0, 120.0)
# the extras: pano_stretch at each (kx, ky), f32 and bf16, forward and
# backward, at the flagship's ERP and batch 2; the DIBR chain (the upstream
# self-supervised path) at the same size, held against the same chain in
# float64 on the card: its images, the cross normals and the curvature at
# the serving bounds (parity_ok), its losses and the chamfer distance within
# EXTRAS_LOSS_TOL (relative). Two results are further from float64 than a
# fixed bound in any f32 run (f32 against float64 on the CPU, at 512x1024):
# the plane fit's normals (its 3x3 Gram matrices are ill-conditioned: 16%
# of the components more than 5% off; at 64x128 the JAX package's lie as
# far, tests/test_torch_port_extras.py) and the depth gradient (the splat's
# floor and weight threshold flip where f32 rounds a coordinate: 1.6% off,
# 8x its move under a one-ulp nudge of the depth). Those two are held to
# the CPU's f32 chain on the same inputs: the plane fit's statistics within
# F64_RATIO times the CPU's distance from float64 (its share above 0.05 plus
# PLANE_FIT_SHARE), the gradient as step_parity holds a train step (the
# CPU's chain as the reference, float64 and the CPU's one-ulp nudge as the
# witnesses). Chamfer runs on CHAMFER_POINTS seeded points of each cloud:
# the whole cloud (524,288 points) would take a block of 1024 x 524,288 x 3
# f32 (6.4 GB) per step
STRETCH_KS = ((1.3, 0.8), (1.0, 1.0))
DIBR_BASELINE, PHOTOMETRIC_WINDOW = 0.26, 7
CHAMFER_POINTS, CHAMFER_BLOCK, EXTRAS_LOSS_TOL, PLANE_FIT_SHARE = 16384, 1024, 1e-5, 1e-4
# the uniform patch layout ("uniform:RxC", the v2 grid): UNIFORM is the JAX
# package's own test's grid (tests/test_variants.py), driven through the
# three models; UNIFORM_STRESS the blend's stress case, 72 patches and up
# to 17 quads per ERP pixel, more than the kernel keeps in registers on half
# of them
UNIFORM, UNIFORM_STRESS = "uniform:4x6", "uniform:6x12"
UNIFORM_LAYOUTS = (UNIFORM, UNIFORM_STRESS)
# uniform_layout's forwards tame the heads to the features that reach them
# (tame_heads_to_features: each head's term at this RMS, the depth bias +2).
# Its train step's witnesses pool the batch and UNIFORM_POOL nudged copies
# of it (each nudge seed moves one ulp at a random half of the values):
# the gradient of mlp_points.0.weight is a residual that train-mode
# BatchNorm nearly cancels (its column of ones takes exactly 0), whose f32
# rounding moves 0.3-2.9% from float64 between draws of the same path (an
# H100, 9 draws at UNIFORM: the kernels 0.74-2.76%, the plain versions
# 0.32-2.89%), so one draw of the witnesses fails a correct path on 4 of 9
# draws at UNIFORM and 1 of 9 at the rings layout; each statistic of
# step_parity is then the median over the draws, held to the same ratios
UNIFORM_HEAD_RMS = {"pred": 0.5, "weight_pred": 1.0}
UNIFORM_POOL = tuple(range(20, 28))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def pin_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


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
    """Hold ``got`` to ``want`` (``verify_kernels.compare``): emit the check's
    line, raise if it does not hold, return the largest difference."""
    torch.cuda.synchronize()
    err, ok = compare(got, want, atol, rtol, chunk)
    if atol == rtol == 0:
        extra["bitwise_equal"] = ok
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


def parity_ok(stats: dict) -> bool:
    # the bounds of the JAX package's upstream parity test
    # (tests/test_reference_parity.py:85-87)
    return (stats["median_rel"] < 1e-3 and stats["q999_rel"] < 0.05
            and stats["frac_rel_gt_0.05"] < 1e-4)


def assert_parity(stats: dict, what: str) -> None:
    if not parity_ok(stats):
        raise AssertionError(f"{what}: {stats}")


def _wrappers() -> dict:
    from omnifusion_torch.ops.heads import fused_heads
    from omnifusion_torch.ops.probe import probe
    from omnifusion_torch.ops.quad_blend import quad_blend, quad_spread
    from omnifusion_torch.ops.upsample import up2x, up2x_adjoint

    return {"quad_blend": quad_blend, "up2x": up2x, "quad_spread": quad_spread,
            "up2x_adjoint": up2x_adjoint, "fused_heads": fused_heads, "probe": probe}


def counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def per_run(forwards: int, steps: int = 0, passes: int = 1) -> dict:
    """The launches of ``forwards`` forwards and ``steps`` train steps (each
    step one forward more, and its backward) of a model of ``passes``
    passes (the one-shot model: 1). A forward blends the ERP into patches,
    and per pass runs the decoder's 5 upsamples and one merge; each pass
    after the first blends the previous depth into quarter-resolution
    patches. The backward spreads through every blend but the first (the
    ERP takes no gradient) and runs each upsample's adjoint. The heads
    kernel runs once a pass in a forward that records no gradients (each of
    the ``forwards``), never in a step."""
    fwd = forwards + steps
    return {"quad_blend": 2 * passes * fwd, "up2x": 5 * passes * fwd,
            "quad_spread": (2 * passes - 1) * steps, "up2x_adjoint": 5 * passes * steps,
            "fused_heads": passes * forwards, "probe": 0}


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


def semantic_batch(spec, b: int, device, seed: int = 0) -> dict:
    """rgb and labels of ``b`` panoramas of cli.train_sem's synthetic set."""
    from omnifusion_torch.data import SyntheticSemanticDataset

    ds = SyntheticSemanticDataset(b, spec.erp_h, spec.erp_w, SEG_CLASSES, seed=seed)
    rgb, labels = (np.stack(c) for c in zip(*(ds[i] for i in range(b))))
    return {"rgb": torch.from_numpy(rgb).to(device), "labels": torch.from_numpy(labels).to(device)}


def synthetic_batch(spec, b: int, device) -> dict:
    from omnifusion_torch.data import SyntheticDataset

    ds = SyntheticDataset(b, spec.erp_h, spec.erp_w, seed=0)
    cols = zip(*(ds[i] for i in range(b)))
    return {k: torch.from_numpy(np.stack(c)).to(device) for k, c in zip(("rgb", "depth", "mask"), cols)}


def bf16_nudged(rgb: torch.Tensor, seed: int) -> torch.Tensor:
    """``rgb`` rounded to bf16 (as the bf16 recipe casts it) and moved up by
    one bf16 ulp at a random half of its values, back in f32 on its device:
    a witness of how far bf16 rounding alone moves a forward or a step."""
    rgb16 = rgb.cpu().bfloat16()
    pick = torch.rand(rgb16.shape, generator=torch.Generator().manual_seed(seed)) < 0.5
    return torch.where(pick, torch.nextafter(rgb16, rgb16 + 1), rgb16).float().to(rgb.device)


def upstream_checkpoint(state_dict: dict, path: str) -> None:
    """Write the port's ``state_dict`` in the upstream layout: the Conv3d
    (k, k, 1) kernels of the upstream model (mlp_points' convs are 2-D
    there), the DataParallel ``module.`` prefix, a ``state_dict`` wrapper."""
    sd = {}
    for k, t in state_dict.items():
        if t.ndim == 4 and not k.startswith("mlp_points"):
            t = t[..., None]
        sd["module." + k] = t.detach().cpu().contiguous()
    torch.save({"state_dict": sd}, path)


def eval_run(argv: list[str]) -> tuple[dict, float, dict, np.ndarray]:
    """omnifusion_torch.cli.test.run_eval on ``argv`` in this process: the
    metrics, the panoramas/s it prints, the kernel launches and the depth
    of its last batch (B, H, W)."""
    import re

    import omnifusion_torch.training as training
    from omnifusion_torch.cli import test as test_cli

    parser = argparse.ArgumentParser()
    test_cli.add_common_args(parser, train=False)
    args = parser.parse_args(argv)
    real, seen = training.eval_step, {}

    def eval_step(model, batch, confidence=True):
        out = real(model, batch, confidence)
        seen["pred"] = out[2]
        return out

    training.eval_step = eval_step  # run_eval imports it at the call
    zero_counts()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            avg = test_cli.run_eval(args)
    finally:
        training.eval_step = real
    launches = counts()
    line = next(x for x in buf.getvalue().splitlines() if x.startswith("## eval:"))
    rate = float(re.search(r"([0-9.]+) panos/s", line).group(1))
    return avg, rate, launches, seen["pred"][..., 0].float().cpu().numpy()


def metric_gaps(ours: dict, ref: dict) -> dict:
    """Per metric, the gap between two runs, relative where it is above 1."""
    return {k: abs(ours[k] - ref[k]) / max(1.0, abs(ref[k])) for k in ref}


# ---- the multi-device path: ddp_gloo2 (two gloo ranks sharing the card,
# spawned by omnifusion_torch.parallel.launch) and mesh1 (the entry points
# with --mesh 1: a process group of one, nccl, DDP and the global
# BatchNorm for real) ----
DDP_RANKS, DDP_KINDS, DDP_TIMED_STEPS = 2, ("oneshot", "iterative", "seg"), 3
# mesh_model: (data, model), the models each rank steps, and whether it
# also runs the batch-2 eval forward
MESH_MODEL_RUNS = (((1, 2), DDP_KINDS, True), ((2, 2), ("oneshot",), False))
# the eval forward on 1 x 2 against the one-process forward, relative to
# the depth: about 4x and 5x the median and 99.9% quantile measured on an
# H100 (9.9e-7, 6.0e-6; only the convolutions' row counts differ), and no
# pixel off by 5%
MESH_EVAL_MEDIAN, MESH_EVAL_Q999 = 4e-6, 3e-5
# GlobalBatchNorm2d against cuDNN's BatchNorm2d, f32: conv1's output at
# the flagship at batch 8 (72 patches per rank), each rank's half drawn
# from another distribution, so that per-rank statistics would differ
BN_CHECK_SHAPE, BN_TOL = (TRAIN_BATCH * 18, 64, 64, 64), 1e-4


def flagship_model(kind: str, device):
    """The flagship model of ``kind``, seeded weights (seed 0), heads tamed."""
    from omnifusion_torch.models import (
        SphericalFusion, SphericalFusionIterative, SphericalFusionSeg, init_weights,
    )
    from omnifusion_torch.projection import ProjectionSpec

    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    if kind == "iterative":
        model = SphericalFusionIterative(spec, num_iters=ITERS, device=device)
    elif kind == "seg":
        model = SphericalFusionSeg(spec, num_classes=SEG_CLASSES, device=device)
    else:
        model = SphericalFusion(spec, device=device)
    model = init_weights(model, 0)
    model.load_state_dict(tame_heads(model.state_dict()))
    return model


def flagship_batch(kind: str, device) -> dict:
    """The batch of the train parity phases: cli.train's synthetic set at
    TRAIN_BATCH, or cli.train_sem's at SEM_PARITY_BATCH."""
    from omnifusion_torch.projection import ProjectionSpec

    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    if kind == "seg":
        return semantic_batch(spec, SEM_PARITY_BATCH, device)
    return synthetic_batch(spec, TRAIN_BATCH, device)


def adamw_step(kind: str, batch: dict, device, ddp: bool = False) -> dict:
    """One train step (forward, backward, AdamW) of the flagship ``kind``
    from its tamed seed-0 weights, cuDNN deterministic; in DDP when
    ``ddp``. The loss the step reports, the gradients (float64, on the
    host), the state after the step and the kernels' launches in it."""
    from omnifusion_torch import parallel
    from omnifusion_torch.training import create_train_state, train_step, train_step_sem

    model = flagship_model(kind, device)
    state = create_train_state(model)
    if ddp:
        state.model = parallel.wrap(model, device)
    zero_counts()
    with deterministic_cudnn():
        m = (train_step_sem(state, batch) if kind == "seg"
             else train_step(state, batch, kind != "iterative"))
    torch.cuda.synchronize()
    return {"loss": m["loss"].item(), "launches": counts(),
            "grads": {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
            "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "global_norms": sum(isinstance(b, parallel.GlobalBatchNorm2d) for b in model.modules()),
            "_state": state}


def gloo_probe(device) -> dict:
    """all_reduce (sum, max), broadcast and all_gather of CUDA tensors on
    this rank's gloo group: what DDP, the global BatchNorm, BerHu's cutoff
    and the sharded eval send."""
    import torch.distributed as dist

    from omnifusion_torch import parallel

    r, w = parallel.rank(), parallel.world()
    t = torch.full((3,), r + 1.0, device=device)
    parallel.all_reduce_(t)
    m = parallel.all_reduce_(torch.tensor([float(r)], device=device), "max")
    b = torch.full((2,), float(r), device=device)
    dist.broadcast(b, 0)
    g = parallel.all_gather_cat(torch.full((1, 2), float(r), device=device))
    ok = (t.tolist() == [w * (w + 1) / 2] * 3 and m.item() == w - 1 and b.tolist() == [0.0, 0.0]
          and g[:, 0].tolist() == [float(i) for i in range(w)])
    return {"ok": ok, "sum": t.tolist(), "max": m.item(), "gather": g[:, 0].tolist()}


def batchnorm_vs_cudnn(device) -> dict:
    """GlobalBatchNorm2d on this rank's half of a BN_CHECK_SHAPE batch
    against cuDNN's nn.BatchNorm2d on the whole batch, f32: the largest
    differences of the output, the input gradient, the affine gradients
    (summed over the ranks) and the running statistics, each relative to
    the largest value of the reference."""
    from omnifusion_torch import parallel

    g = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(BN_CHECK_SHAPE, device=device, generator=g)
    half = BN_CHECK_SHAPE[0] // 2
    x[half:] = x[half:] * 2 + 0.5
    dy = torch.randn(BN_CHECK_SHAPE, device=device, generator=g)
    c = BN_CHECK_SHAPE[1]
    w0 = torch.rand(c, device=device, generator=g) + 0.5
    b0 = torch.randn(c, device=device, generator=g)

    def norm(cls):
        bn = cls(c, device=device)
        with torch.no_grad():
            bn.weight.copy_(w0)
            bn.bias.copy_(b0)
        return bn

    ref = norm(torch.nn.BatchNorm2d)
    xr = x.clone().requires_grad_()
    y_ref = ref(xr)
    y_ref.backward(dy)
    y_ref = y_ref.detach()
    rows = slice(parallel.rank() * half, (parallel.rank() + 1) * half)
    bn = norm(parallel.GlobalBatchNorm2d)
    xs = x[rows].clone().requires_grad_()
    y = bn(xs)
    y.backward(dy[rows])
    y = y.detach()
    dw = parallel.all_reduce_(bn.weight.grad.clone())
    db = parallel.all_reduce_(bn.bias.grad.clone())

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out = {"out": rel(y, y_ref[rows]), "dx": rel(xs.grad, xr.grad[rows]),
           "dweight": rel(dw, ref.weight.grad), "dbias": rel(db, ref.bias.grad),
           "running_mean": rel(bn.running_mean, ref.running_mean),
           "running_var": rel(bn.running_var, ref.running_var)}
    # what this rank's own statistics would give instead
    out["own_statistics_out"] = rel(torch.nn.functional.batch_norm(
        x[rows], None, None, w0, b0, True), y_ref[rows])
    return out


def ddp_gloo2_rank() -> dict:
    """One rank of ddp_gloo2: the gloo probe, the BatchNorm check, then
    mesh_steps_rank's steps of every model."""
    from omnifusion_torch import parallel

    pin_f32()
    dev = parallel.device()
    out = {"probe": gloo_probe(dev), "batchnorm": batchnorm_vs_cudnn(dev)}
    torch.cuda.empty_cache()
    return {**out, **mesh_steps_rank(DDP_KINDS, False)}


def mesh_steps_rank(kinds: tuple, with_eval: bool) -> dict:
    """One rank of ddp_gloo2 or mesh_model: one DDP train step of each of
    ``kinds`` on its data group's part of the flagship batch (under a model
    axis the trunk on its model rank's chunk of that part's patches), then
    DDP_TIMED_STEPS more one-shot steps, timed; with ``with_eval``, the
    one-shot eval forward of BATCH panoramas. Rank 0 returns the gradients,
    the states and the depth; every rank its launches."""
    from omnifusion_torch import parallel
    from omnifusion_torch.parallel.model_axis import row_chunks
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.training import train_step

    pin_f32()
    dev = parallel.device()
    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    dr, dw = parallel.data_rank(), parallel.data_world()
    out = {"rank": parallel.rank(), "mesh": parallel.current_mesh().shape,
           "rows": row_chunks(TRAIN_BATCH // dw * spec.n_patches)[parallel.model_rank()]}
    for kind in kinds:
        batch = flagship_batch(kind, dev)
        k = len(batch["rgb"]) // dw
        b = {name: v[dr * k : (dr + 1) * k] for name, v in batch.items()}
        res = adamw_step(kind, b, dev, ddp=True)
        state = res.pop("_state")
        if kind == "oneshot":
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DDP_TIMED_STEPS):
                train_step(state, b)
            torch.cuda.synchronize()
            out["step_wall_ms"] = (time.perf_counter() - t0) * 1e3 / DDP_TIMED_STEPS
            out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        del state
        torch.cuda.empty_cache()
        if parallel.rank() != 0:
            res = {"launches": res["launches"], "loss": res["loss"]}
        out[kind] = res
    if with_eval:
        rgb = synthetic_batch(spec, BATCH, dev)["rgb"]
        k = BATCH // dw
        model = flagship_model("oneshot", dev).eval()
        zero_counts()
        with torch.inference_mode(), deterministic_cudnn():
            depth = model(rgb[dr * k : (dr + 1) * k])
        torch.cuda.synchronize()
        out["eval"] = {"launches": counts()}
        if parallel.rank() == 0:
            out["eval"]["depth"] = depth[..., 0].cpu().numpy()
    return out


def params_after_parity(ours: dict, ref: dict) -> dict:
    """The parameters after the step, where the reference gradient is above
    the noise floor (10 times the two gradients' difference, and 1000 times
    AdamW's eps): there the first update, lr * g / (|g| + eps), differs
    between the two by less than 1e-4 lr, and the parameters agree within
    1e-3 lr + 1e-6 |p| (the bounds of tests/test_torch_port_train.py).
    ``excess``: the largest difference beyond the 1e-6 |p| part, held to
    1e-3 lr."""
    lr, excess, compared, total = 1e-4, 0.0, 0, 0
    for n, g in ref["grads"].items():
        live = (g.abs() > 10 * (ours["grads"][n] - g).abs()) & (g.abs() > 1000 * 1e-8)
        p = ref["state"][n].double()[live]
        d = (ours["state"][n].double()[live] - p).abs() - 1e-6 * p.abs()
        excess = max(excess, float(d.max()) if d.numel() else 0.0)
        compared += int(live.sum())
        total += g.numel()
    return {"excess": excess, "bound": 1e-3 * lr, "live_frac": compared / total}


def stats_parity(ours: dict, ref: dict) -> dict:
    rels = [float((ours[k] - ref[k]).norm() / ref[k].norm())
            for k in ref if k.endswith(("running_mean", "running_var"))]
    return {"median": float(np.median(rels)), "max": max(rels), "tensors": len(rels)}


def one_process_refs(dev) -> dict:
    """The one-process references of ddp_gloo2 and mesh_model, by model:
    the flagship train step (adamw_step) and, as the witness of f32
    rounding, its loss and gradients on the nudged batch."""
    refs = {}
    for kind in DDP_KINDS:
        batch = flagship_batch(kind, dev)
        ref = adamw_step(kind, batch, dev)
        ref.pop("_state")
        model = flagship_model(kind, dev)
        sd0 = copy.deepcopy(model.state_dict())
        with deterministic_cudnn():
            nudge = loss_and_grads(model, nudged(batch, 5), sd0, confidence=kind != "iterative")
        refs[kind] = ref, nudge
        del model, batch
        torch.cuda.empty_cache()
    return refs


def mesh_parity(kind: str, ranks: list, refs: dict, f64_witness: dict, passes: int) -> dict:
    """Rank 0's train step of ``kind`` against the one-process step, as
    ddp_gloo2 and mesh_model hold it, and every rank's launches against
    one step's."""
    ref, nudge = refs[kind]
    ours = ranks[0][kind]
    par, good = step_parity((ours["loss"], ours["grads"]), (ref["loss"], ref["grads"]),
                            f64_witness[kind], nudge)
    params = params_after_parity(ours, ref)
    stats = stats_parity(ours["state"], ref["state"])
    want = per_run(0, 1, passes)
    rank_launches = [r[kind]["launches"] for r in ranks]
    good = (good and params["excess"] <= params["bound"] and params["live_frac"] > 0.2
            and stats["median"] < GRAD_TOL and ours["global_norms"] > 0
            and ref["global_norms"] == 0 and all(lc == want for lc in rank_launches))
    return {"parity": par, "params_after_step": params, "running_stats": stats,
            "launches_per_rank": rank_launches, "launches_expected": want, "ok": good}


def mesh_model_phase(gpu: str, refs: dict, f64_witness: dict) -> dict:
    """mesh_model: the runs of MESH_MODEL_RUNS, each as gloo ranks sharing
    the card, held to ``refs`` (one_process_refs) with ``f64_witness``, and
    the eval forward to the one-process forward (MESH_EVAL_MEDIAN,
    MESH_EVAL_Q999).
    Returns each run's rank-0 one-shot launches for the kernels line."""
    from omnifusion_torch import parallel
    from omnifusion_torch.parallel.launch import spawn
    from omnifusion_torch.projection import ProjectionSpec

    dev = torch.device(DEVICE)
    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    model = flagship_model("oneshot", dev).eval()
    with torch.inference_mode(), deterministic_cudnn():
        ref_depth = model(synthetic_batch(spec, BATCH, dev)["rgb"])[..., 0].cpu().numpy()
    del model
    torch.cuda.empty_cache()
    launches = {}
    for (d, m), kinds, with_eval in MESH_MODEL_RUNS:
        t0 = time.perf_counter()
        mesh = parallel.Mesh(d, m)
        ranks = spawn(mesh_steps_rank, d * m, (kinds, with_eval), lambda r: f"{DEVICE}:0",
                      "gloo", 600, mesh)
        spawn_s = time.perf_counter() - t0
        result = {kind: mesh_parity(kind, ranks, refs, f64_witness,
                                    ITERS if kind == "iterative" else 1) for kind in kinds}
        ok = all(r["ok"] for r in result.values())
        if with_eval:
            stats = rel_stats(ranks[0]["eval"]["depth"], ref_depth)
            eval_launches = [r["eval"]["launches"] for r in ranks]
            good = (stats["median_rel"] < MESH_EVAL_MEDIAN and stats["q999_rel"] < MESH_EVAL_Q999
                    and stats["frac_rel_gt_0.05"] == 0
                    and all(lc == per_run(1) for lc in eval_launches))
            result["eval_forward"] = {"batch": BATCH, "vs_one_process": stats,
                                      "bounds": {"median_rel": MESH_EVAL_MEDIAN,
                                                 "q999_rel": MESH_EVAL_Q999,
                                                 "frac_rel_gt_0.05": 0},
                                      "launches_per_rank": eval_launches,
                                      "launches_expected": per_run(1), "ok": good}
            ok = ok and good
        per_group = TRAIN_BATCH // d
        launches[f"{d}x{m}"] = ranks[0]["oneshot"]["launches"]
        emit({"phase": "mesh_model", "gpu": gpu, "mesh": mesh.shape, "ranks": d * m,
              "backend": "gloo", "device": f"{DEVICE}:0 shared",
              "batch": f"{TRAIN_BATCH} global, {per_group} per data group",
              "rows_per_rank": [r["rows"] for r in ranks],
              **result, "step_wall_ms_per_rank": [r["step_wall_ms"] for r in ranks],
              "step_wall_ms_note": "not a scaling number: ranks share one card and gloo "
                                   "stages CUDA tensors through the host",
              "max_memory_allocated_bytes_per_rank":
                  [r["max_memory_allocated_bytes"] for r in ranks],
              "seconds_with_spawn": spawn_s, "ok": ok})
        if not ok:
            raise AssertionError(f"mesh_model {mesh.shape}: see its line")
    return launches


def smooth_depth(b: int, h: int, w: int, device, seed: int, lo: float = 1.0,
                 hi: float = 8.0) -> torch.Tensor:
    """(B, H, W, 1) f32 depth in [lo, hi] on ``device``: per panorama four
    low-frequency cosines with seeded amplitudes, frequencies and phases."""
    g = torch.Generator().manual_seed(seed)
    y = torch.linspace(0, 1, h, dtype=torch.float64)[:, None]
    x = torch.linspace(0, 1, w, dtype=torch.float64)[None]

    def draw():
        fx, fy = torch.randint(1, 4, (2,), generator=g).tolist()
        a, phase = torch.rand(2, generator=g, dtype=torch.float64).tolist()
        return a * torch.cos(2 * np.pi * (fx * x + (fy - 1) * y) + 6 * phase)

    maps = []
    for _ in range(b):
        d = sum(draw() for _ in range(4))
        maps.append(lo + (hi - lo) * (d - d.min()) / (d.max() - d.min()))
    return torch.stack(maps)[..., None].float().to(device)


def extras_chain(depth: torch.Tensor, rgb: torch.Tensor, true_depth: torch.Tensor,
                 pick: torch.Tensor):
    """The DIBR chain in ``depth``'s dtype: the views shifted vertically and
    horizontally by DIBR_BASELINE, each held to ``rgb`` by the photometric
    loss (Gaussian SSIM, window PHOTOMETRIC_WINDOW) on the pixels it
    rendered; the guided smoothness loss of the depth's Sobel gradients
    (imgrad_yx) under the rgb's; the backward of their sum to the depth;
    the normals (cross, with the curvature, and the plane fit); the
    symmetric chamfer distance between the ``pick`` points of the depth's
    cloud and of ``true_depth``'s. Returns (images and normals, losses,
    the depth's gradient)."""
    from omnifusion_torch.evaluation import chamfer_distance_symmetric
    from omnifusion_torch.geometry.sphere import create_image_grid, create_spherical_grid
    from omnifusion_torch.losses import (
        PhotometricLossParameters, guided_smoothness_loss, photometric_loss,
    )
    from omnifusion_torch.ops import (
        depth_to_points, dibr_horizontal, dibr_vertical, imgrad_yx, normals_cross,
        normals_plane_fit,
    )

    b, h, w, _ = depth.shape
    dev, dt = depth.device, depth.dtype
    uv = torch.from_numpy(create_image_grid(w, h)).to(dev, dt).expand(b, h, w, 2)
    sg = torch.from_numpy(create_spherical_grid(w)).to(dev, dt).expand(b, h, w, 2)
    depth = depth.detach().requires_grad_()
    images = {"dibr_vertical": dibr_vertical(depth, rgb, uv, sg, DIBR_BASELINE),
              "dibr_horizontal": dibr_horizontal(depth, rgb, uv, sg, DIBR_BASELINE)}
    params = PhotometricLossParameters(window=PHOTOMETRIC_WINDOW)
    losses = {f"photometric_{k}": photometric_loss(v, rgb, params, (v.detach() != 0).any(
        -1, keepdim=True)) for k, v in images.items()}
    losses["guided_smoothness"] = guided_smoothness_loss(
        imgrad_yx(depth).abs(), imgrad_yx(rgb).abs(), depth.detach() > 0)
    sum(losses.values()).backward()
    with torch.no_grad():
        images["normals_cross"], images["curvature"] = normals_cross(depth, return_curvature=True)
        images["normals_plane_fit"] = normals_plane_fit(depth)
        clouds = [depth_to_points(d).reshape(b, h * w, 3)[:, pick] for d in (depth, true_depth)]
        losses["chamfer_symmetric"] = chamfer_distance_symmetric(*clouds, block=CHAMFER_BLOCK)
    return ({k: v.detach() for k, v in images.items()}, {k: v.item() for k, v in losses.items()},
            depth.grad)


def extras_phase(gpu: str, timer) -> dict:
    """The extras (see STRETCH_KS): the stretch's tables and its path, each
    call held to the plain blend and spread, its time rows beside F.grid_sample;
    the DIBR chain against float64, and its time rows. Returns the stretch
    path's launches, its time rows by kernel and the largest f32 differences
    from the plain versions."""
    import torch.nn.functional as F

    from omnifusion_torch.evaluation import chamfer_distance_symmetric
    from omnifusion_torch.geometry.sphere import create_image_grid, create_spherical_grid
    from omnifusion_torch.losses import (
        PhotometricLossParameters, guided_smoothness_loss, photometric_loss,
    )
    from omnifusion_torch.ops import (
        depth_to_points, dibr_horizontal, dibr_vertical, imgrad_yx, normals_cross,
        normals_plane_fit, pano_stretch,
    )
    from omnifusion_torch.ops.pano_stretch import stretch_grid, stretch_tables
    from omnifusion_torch.ops.quad_blend import (
        STAGE_MAX_FOOTPRINT, quad_blend, quad_blend_plain, quad_spread, quad_spread_plain,
    )
    from omnifusion_torch.utils.profiling import blend_bound, nbytes, spread_bound

    dev = torch.device(DEVICE)
    b, (h, w) = BATCH, ERP
    g = torch.Generator(device=dev).manual_seed(13)
    t0_phase = time.perf_counter()

    # ---- the stretch's tables (host seconds, each pair built once) ----
    tables, build_s = {}, {}
    for ks in STRETCH_KS:
        t0 = time.perf_counter()
        tables[ks] = stretch_tables(h, w, *ks, dev)
        build_s[f"{ks[0]},{ks[1]}"] = time.perf_counter() - t0
    emit({"phase": "tables_stretch", "seconds": build_s, **{
        f"{ks[0]},{ks[1]}": {"n_out": t.n_out, "k": t.k, "n_in": t.n_in,
                             "tile": list(t.tiles.shape), "tiles": t.tiles.n_tiles,
                             "max_footprint_pixels": t.tiles.pitch,
                             "footprint_per_output": t.tiles.footprint,
                             "staged": t.tiles.footprint <= STAGE_MAX_FOOTPRINT,
                             "k_t": t.vjp.k_t, "overflow": t.vjp.n_over,
                             "heavy_pixels": t.vjp.heavy.numel()}
        for ks, t in tables.items()}})

    # ---- the path: pano_stretch forward and backward through the public
    # op, each (kx, ky), f32 and bf16, its launches counted ----
    x32 = torch.rand(b, h, w, 3, device=dev, generator=g)
    cot32 = torch.rand(b, h, w, 3, device=dev, generator=g)
    runs = {}
    zero_counts()
    for ks in STRETCH_KS:
        for dt in (torch.float32, torch.bfloat16):
            img = x32.to(dt, copy=True).requires_grad_()  # a leaf of its own
            out = pano_stretch(img, *ks)
            out.backward(cot32.to(dt))
            runs[ks, dt] = img, out.detach()
    torch.cuda.synchronize()
    launches = counts()
    want = {k: 0 for k in launches}
    want.update(quad_blend=len(runs), quad_spread=len(runs))
    emit({"phase": "extras_stretch", "shape": [b, h, w, 3], "ks": [list(k) for k in STRETCH_KS],
          "dtypes": ["float32", "bfloat16"], "launches": launches, "launches_expected": want})
    if launches != want:
        raise AssertionError(f"pano_stretch launches {launches}, expected {want}")
    errs = {"quad_blend": 0.0, "quad_spread": 0.0}
    for (ks, dt), (img, out) in runs.items():
        t = tables[ks]
        case = f"pano_stretch_{ks[0]}_{ks[1]}_{str(dt)[6:]}"
        f32 = dt == torch.float32
        rows_in = img.detach().reshape(b, h * w, 3)
        err = check("quad_blend", case, out.reshape(b, h * w, 3),
                    quad_blend_plain(rows_in, t, True, dt), BLEND_TOL,
                    0.0 if f32 else UP2X_BF16_RTOL, footprint=t.tiles.footprint)
        s_atol, s_rtol = SPREAD_TOL[dt]
        s_err = check("quad_spread", case, img.grad.reshape(b, h * w, 3),
                      quad_spread_plain(cot32.to(dt).reshape(b, h * w, 3), t.vjp, True).to(dt),
                      s_atol, s_rtol, overflow=t.vjp.n_over)
        if f32:
            errs["quad_blend"] = max(errs["quad_blend"], err)
            errs["quad_spread"] = max(errs["quad_spread"], s_err)
    del runs, img, out

    # ---- its time rows: (1.3, 0.8), f32, the kernels beside their bounds,
    # plain versions and F.grid_sample (forward; its backward for the
    # spread) on the same grid ----
    ks = STRETCH_KS[0]
    t = tables[ks]
    x, cot = x32.reshape(b, h * w, 3), cot32.reshape(b, h * w, 3)
    out = quad_blend(x, t, True, torch.float32)
    grad = quad_spread(cot, t.vjp, True)
    grid = torch.from_numpy(np.stack(stretch_grid(h, w, *ks), -1)).float().to(dev)
    grid = grid.expand(b, h, w, 2).contiguous()
    x_nchw, cot_nchw = (a.permute(0, 3, 1, 2).contiguous() for a in (x32, cot32))

    def lib():
        return F.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    def lib_backward():  # bilinear (0), zeros (0), align_corners, the input's gradient only
        return torch.ops.aten.grid_sampler_2d_backward(cot_nchw, x_nchw, grid, 0, 0, True,
                                                       [True, False])[0]

    def nhwc_rows(a):
        return a.permute(0, 2, 3, 1).reshape(b, h * w, 3)

    rows = {}
    b_ms, b_by = blend_bound(x, t, out)
    rows["quad_blend"] = {
        "case": "pano_stretch", "kx": ks[0], "ky": ks[1], "shape": [b, h, w, 3], "dtype": "float32",
        "launches": launches["quad_blend"],
        "ms": timer(lambda: quad_blend(x, t, True, torch.float32)),
        "plain_ms": timer(lambda: quad_blend_plain(x, t, True, torch.float32), iters=5, warmup=1),
        "library": "F.grid_sample(bilinear, zeros, align_corners=True)", "library_ms": timer(lib),
        "library_max_abs_err": (nhwc_rows(lib()) - out).abs().max().item(),
        "bound_ms": b_ms, "bound_by": b_by,
        "tile_table_bytes": nbytes(t.tiles.off, t.tiles.grp, t.tiles.grp_ptr),
    }
    s_ms, s_by = spread_bound(cot, t.vjp, grad)
    rows["quad_spread"] = {
        "case": "pano_stretch_backward", "kx": ks[0], "ky": ks[1], "shape": [b, h, w, 3],
        "dtype": "float32", "launches": launches["quad_spread"], "overflow": t.vjp.n_over,
        "heavy": t.vjp.heavy.numel(),
        "ms": timer(lambda: quad_spread(cot, t.vjp, True)),
        "plain_ms": timer(lambda: quad_spread_plain(cot, t.vjp, True), iters=5, warmup=1),
        "library": "aten.grid_sampler_2d_backward (F.grid_sample's input gradient)",
        "library_ms": timer(lib_backward),
        "library_max_abs_err": (nhwc_rows(lib_backward()) - grad).abs().max().item(),
        "bound_ms": s_ms, "bound_by": s_by,
    }
    for kernel, r in rows.items():
        emit({"phase": "time", "kernel": kernel, "gpu": gpu, **r})
    del x, cot, out, grad, grid, x_nchw, cot_nchw

    # ---- the DIBR chain against float64, with the CPU's f32 chain (the
    # path the tests hold to the JAX package) as the witness where f32
    # rounding alone moves a result past a fixed bound ----
    depth = smooth_depth(b, h, w, dev, seed=21)
    true_depth = smooth_depth(b, h, w, dev, seed=22)
    rgb = torch.rand(b, h, w, 3, device=dev, generator=g)
    pick = torch.randperm(h * w, generator=torch.Generator().manual_seed(23))[:CHAMFER_POINTS]
    nudge = torch.rand(depth.shape, generator=torch.Generator().manual_seed(24)) < 0.5
    ims, losses, grad = extras_chain(depth, rgb, true_depth, pick.to(dev))
    ims64, losses64, grad64 = extras_chain(depth.double(), rgb.double(), true_depth.double(),
                                           pick.to(dev))
    host = [a.cpu() for a in (depth, rgb, true_depth)] + [pick]
    ims_cpu, losses_cpu, grad_cpu = extras_chain(*host)
    nudged = torch.where(nudge, torch.nextafter(host[0], host[0] + 1), host[0])
    _, losses_nudged, grad_nudged = extras_chain(nudged, *host[1:])
    ref = {k: v.cpu().numpy() for k, v in ims64.items()}
    image_stats = {k: rel_stats(v.cpu().numpy(), ref[k]) for k, v in ims.items()}
    plane_cpu = rel_stats(ims_cpu["normals_plane_fit"].numpy(), ref["normals_plane_fit"])
    loss_rel = {k: abs(v / losses64[k] - 1) for k, v in losses.items()}
    differentiated = [k for k in losses if k != "chamfer_symmetric"]

    def step(ls, gr):  # step_parity's (loss, {name: gradient})
        return sum(ls[k] for k in differentiated), {"depth": gr.detach().double().cpu()}

    grad_par, grad_ok = step_parity(step(losses, grad), step(losses_cpu, grad_cpu),
                                    step(losses64, grad64), step(losses_nudged, grad_nudged),
                                    loss_tol=EXTRAS_LOSS_TOL)
    plane = image_stats["normals_plane_fit"]
    ok = (all(parity_ok(st) for k, st in image_stats.items() if k != "normals_plane_fit")
          and all(plane[k] <= F64_RATIO * plane_cpu[k] + (PLANE_FIT_SHARE if k.startswith("frac")
                                                          else 0.0)
                  for k in ("median_rel", "q999_rel", "frac_rel_gt_0.05"))
          and all(r < EXTRAS_LOSS_TOL for r in loss_rel.values()) and grad_ok)
    emit({"phase": "extras_dibr", "shape": [b, h, w], "baseline": DIBR_BASELINE,
          "photometric_window": PHOTOMETRIC_WINDOW, "chamfer_points": CHAMFER_POINTS,
          "precision": "f32 (tf32 off) against float64 on the card", "images": image_stats,
          "normals_plane_fit_cpu_f32": plane_cpu, "plane_fit_ratio": F64_RATIO,
          "plane_fit_share_slack": PLANE_FIT_SHARE, "losses": losses, "losses_f64": losses64,
          "losses_cpu": losses_cpu, "loss_rel": loss_rel, "loss_tol": EXTRAS_LOSS_TOL,
          "depth_grad": grad_par, "f64_ratio": F64_RATIO, "ulp_ratio": ULP_RATIO,
          "finite": all(bool(torch.isfinite(v).all()) for v in ims.values())})
    if not ok or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError("extras_dibr: see its line")
    del ims64, grad64, ims_cpu, grad_cpu, grad_nudged, host, nudged, ref
    pick = pick.to(dev)

    # ---- its time rows: device ms per call of each extra at that size ----
    uv = torch.from_numpy(create_image_grid(w, h)).to(dev).float().expand(b, h, w, 2)
    sg = torch.from_numpy(create_spherical_grid(w)).to(dev).float().expand(b, h, w, 2)
    view = ims["dibr_vertical"]
    mask = (view != 0).any(-1, keepdim=True)
    params = PhotometricLossParameters(window=PHOTOMETRIC_WINDOW)
    clouds = [depth_to_points(d).reshape(b, h * w, 3)[:, pick] for d in (depth, true_depth)]
    calls = {
        "dibr_vertical": lambda: dibr_vertical(depth, rgb, uv, sg, DIBR_BASELINE),
        "dibr_horizontal": lambda: dibr_horizontal(depth, rgb, uv, sg, DIBR_BASELINE),
        "photometric_loss": lambda: photometric_loss(view, rgb, params, mask),
        "guided_smoothness_loss": lambda: guided_smoothness_loss(
            imgrad_yx(depth).abs(), imgrad_yx(rgb).abs(), depth > 0),
        "normals_cross": lambda: normals_cross(depth, return_curvature=True),
        "normals_plane_fit": lambda: normals_plane_fit(depth),
        "chamfer_distance_symmetric": lambda: chamfer_distance_symmetric(*clouds,
                                                                         block=CHAMFER_BLOCK),
        "chain_with_backward": lambda: extras_chain(depth, rgb, true_depth, pick),
    }
    emit({"phase": "time_extras", "gpu": gpu, "shape": [b, h, w],
          "ms": {k: timer(fn, iters=5, warmup=1) for k, fn in calls.items()}})
    emit({"phase": "extras", "seconds": time.perf_counter() - t0_phase})
    stretch_tables.cache_clear()
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows, "errs": errs}


def _plan(tiles, units: int, cpu: int, elem_size: int) -> dict:
    from omnifusion_torch.ops.quad_blend import blend_plan

    staged, chunk, unit_block = blend_plan(tiles, units, cpu, elem_size)
    return {"staged": staged, "chunk_units": chunk, "unit_block": unit_block}


def uniform_tables_phase(dev) -> dict:
    """tables_uniform: each uniform layout's tables at the flagship, the
    host seconds of each part (the spec's numpy tables, the kernel's tile
    tables, the transposed tables with the heavy list), the merge's quads
    per ERP pixel, the footprints, the plans the blend's rule picks and the
    heavy pixels; and the quarter-resolution equi2pers of UNIFORM. Returns
    {layout: (spec, e2p tables, merge tables)} and the quarter tables."""
    from omnifusion_torch.ops import quad_blend as qb
    from omnifusion_torch.ops.quad_blend import SpreadTables, overflow_load
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
    from omnifusion_torch.projection.spec import build_equi2pers_grids, build_pers2equi_grids

    out, info = {}, {}
    for layout in UNIFORM_LAYOUTS:
        spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS, layout=layout)
        t0 = time.perf_counter()
        grids = build_equi2pers_grids(spec), build_pers2equi_grids(spec)
        spec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        t_e2p, t_p2e = equi2pers_tables(spec, dev), pers2equi_tables(spec, dev)
        torch.cuda.synchronize()
        on_card_s = time.perf_counter() - t0
        tile_s, spread_s = {}, {}
        for name, t, g, stride in (("e2p", t_e2p, grids[0], spec.erp_w),
                                   ("merge", t_p2e, grids[1], spec.patch_w)):
            t0 = time.perf_counter()
            t.with_tiles(t.tiles.shape)
            tile_s[name] = time.perf_counter() - t0
            t0 = time.perf_counter()
            SpreadTables.create(g.vjp, stride, t.n_out, dev)
            torch.cuda.synchronize()
            spread_s[name] = time.perf_counter() - t0
        quads = (grids[1].w4.sum(-1) > 0).sum(1)
        out[layout] = spec, t_e2p, t_p2e
        info[layout] = {
            "patches": spec.n_patches,
            "seconds": {"spec_tables": spec_s, "tile_tables": tile_s, "spread_tables": spread_s,
                        "blend_tables_on_card": on_card_s},
            "e2p": {"n_out": t_e2p.n_out, "k": t_e2p.k, "tile": list(t_e2p.tiles.shape),
                    "max_footprint_pixels": t_e2p.tiles.pitch,
                    "footprint_per_output": t_e2p.tiles.footprint,
                    "entries": t_e2p.tiles.entries,
                    "plan_b2_f32": _plan(t_e2p.tiles, BATCH, 3, 4),
                    "plan_b2_bf16": _plan(t_e2p.tiles, BATCH, 3, 2),
                    "k_t": t_e2p.vjp.k_t, "overflow": t_e2p.vjp.n_over,
                    "heavy_pixels": t_e2p.vjp.heavy.numel()},
            "merge": {"n_in": t_p2e.n_in, "k_dense": int(grids[1].idx.shape[1]), "k": t_p2e.k,
                      "tail_entries": t_p2e.n_tail, "entries": t_p2e.tiles.entries,
                      "register_budget": qb.MAX_ENTRIES,
                      "quads_per_pixel_max": int(quads.max()),
                      "quads_per_pixel_mean": float(quads.mean()),
                      "share_past_capped_k": float((quads > t_p2e.k).mean()),
                      "share_past_register_budget": float((quads > qb.MAX_ENTRIES).mean()),
                      "tile": list(t_p2e.tiles.shape), "max_footprint_pixels": t_p2e.tiles.pitch,
                      "footprint_per_output": t_p2e.tiles.footprint,
                      "stage_max_footprint": qb.STAGE_MAX_FOOTPRINT,
                      "plan_b2_f32": _plan(t_p2e.tiles, 2 * BATCH, 1, 4),
                      "plan_b8_f16": _plan(t_p2e.tiles, 2 * TRAIN_BATCH, 1, 2),
                      "k_t": t_p2e.vjp.k_t, "overflow": t_p2e.vjp.n_over,
                      "max_overflow_load": int(overflow_load(
                          t_p2e.vjp.over_ptr.cpu().numpy(), PATCH).max()),
                      "heavy_threshold": t_p2e.vjp.threshold,
                      "heavy_pixels": t_p2e.vjp.heavy.numel(), "wide": t_p2e.vjp.n_wide}}
    spec_q = out[UNIFORM][0].with_patch_scale(4)
    t0 = time.perf_counter()
    t_q = equi2pers_tables(spec_q, dev)
    info["e2p_q"] = {"layout": UNIFORM, "patch": spec_q.patch_h, "seconds": time.perf_counter() - t0,
                     "n_out": t_q.n_out, "tile": list(t_q.tiles.shape),
                     "footprint_per_output": t_q.tiles.footprint,
                     "plan_b2": _plan(t_q.tiles, BATCH, 1, 4), "k_t": t_q.vjp.k_t,
                     "overflow": t_q.vjp.n_over, "heavy_pixels": t_q.vjp.heavy.numel()}
    emit({"phase": "tables_uniform", **info})
    stress = info[UNIFORM_STRESS]["merge"]
    if stress["entries"] <= qb.MAX_ENTRIES:
        raise AssertionError(f"the {UNIFORM_STRESS} merge holds {stress['entries']} quads per "
                             f"pixel, not more than the register budget")
    return out, t_q


def uniform_checks(tables: dict, t_q, dev, g) -> dict:
    """Each kernel on the uniform layouts' tables against its plain version
    (the rings rows' tolerances): the blend for equi2pers (f32 and bf16
    sources, f32 results; the bf16 store bit for bit the cast of the f32
    result) and for the merge (f32 and f16), at batches 2 and 8, the merge
    also staged and gathered from global memory; the spread on each merge's
    cotangent at batch 8 (f32, f16 and bf16), three calls bit for bit; the
    quarter-resolution equi2pers and its spread. Returns the largest f32
    differences."""
    from omnifusion_torch.ops import quad_blend as qb
    from omnifusion_torch.ops.quad_blend import (
        quad_blend, quad_blend_plain, quad_spread, quad_spread_plain,
    )

    errs = {"quad_blend": 0.0, "quad_spread": 0.0}

    def note(name, err, f32=True):
        if f32:
            errs[name] = max(errs[name], err)

    n_erp = ERP[0] * ERP[1]
    atol, rtol = SPREAD_TOL[torch.float32]
    for layout, (_, t_e2p, t_p2e) in tables.items():
        tag = layout.split(":")[1]
        for b in (BATCH, TRAIN_BATCH):
            x = torch.rand(b, n_erp, 3, device=dev, generator=g)
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                got = quad_blend(xd, t_e2p, channel_last=True)
                note("quad_blend", check("quad_blend", f"e2p_{tag}_{str(dt)[6:]}_b{b}", got,
                                         quad_blend_plain(xd, t_e2p, channel_last=True),
                                         BLEND_TOL, footprint=t_e2p.tiles.footprint),
                     dt == torch.float32)
                if dt == torch.bfloat16:
                    stored = quad_blend(xd, t_e2p, channel_last=True, out_dtype=dt)
                    torch.cuda.synchronize()
                    same = torch.equal(stored, got.to(dt))
                    emit({"phase": "check", "kernel": "quad_blend",
                          "case": f"e2p_{tag}_bfloat16_store_b{b}",
                          "bitwise_equal_to_cast": same})
                    if not same:
                        raise AssertionError(f"quad_blend e2p {tag} bf16 store differs from the cast")
            x = torch.rand(b, 2, t_p2e.n_in, device=dev, generator=g)
            for dt in (torch.float32, torch.float16):
                xd = x.to(dt)
                want = quad_blend_plain(xd, t_p2e)
                note("quad_blend", check("quad_blend", f"merge_{tag}_{str(dt)[6:]}_b{b}",
                                         quad_blend(xd, t_p2e), want, BLEND_TOL,
                                         entries=t_p2e.tiles.entries, tail_entries=t_p2e.n_tail),
                     dt == torch.float32)
                if b == BATCH:  # the plan the rule did not pick, too
                    for staged in (True, False):
                        note("quad_blend", check(
                            "quad_blend", f"merge_{tag}_{str(dt)[6:]}_b{b}_staged_{staged}",
                            qb._blend_kernel(xd, t_p2e, False, staged=staged), want, BLEND_TOL,
                            entries=t_p2e.tiles.entries), dt == torch.float32)
        cot = torch.rand(TRAIN_BATCH, 2, n_erp, device=dev, generator=g)
        for dt in (torch.float32, torch.float16, torch.bfloat16):
            c = cot.to(dt)
            note("quad_spread", check("quad_spread", f"merge_{tag}_{str(dt)[6:]}_cot_b{TRAIN_BATCH}",
                                      quad_spread(c, t_p2e.vjp), quad_spread_plain(c, t_p2e.vjp),
                                      atol, rtol, overflow=t_p2e.vjp.n_over,
                                      heavy=t_p2e.vjp.heavy.numel()))
        calls = [quad_spread(cot, t_p2e.vjp) for _ in range(3)]
        torch.cuda.synchronize()
        same = all(torch.equal(calls[0], c) for c in calls[1:])
        emit({"phase": "check", "kernel": "quad_spread", "case": f"merge_{tag}_run_to_run",
              "calls": 3, "bitwise_equal": same})
        if not same:
            raise AssertionError(f"quad_spread merge {tag}: calls differ")
        del x, xd, want, got, cot, c, calls
    tag = UNIFORM.split(":")[1]
    for b in (BATCH, TRAIN_BATCH):
        depth = torch.rand(b, n_erp, 1, device=dev, generator=g) * 7 + 0.3
        note("quad_blend", check("quad_blend", f"e2p_q_{tag}_b{b}",
                                 quad_blend(depth, t_q, channel_last=True),
                                 quad_blend_plain(depth, t_q, channel_last=True), BLEND_TOL,
                                 BLEND_TOL))
        cot = torch.rand(b, t_q.n_out, 1, device=dev, generator=g)
        note("quad_spread", check("quad_spread", f"e2p_q_{tag}_b{b}",
                                  quad_spread(cot, t_q.vjp, channel_last=True),
                                  quad_spread_plain(cot, t_q.vjp, channel_last=True), atol, rtol,
                                  overflow=t_q.vjp.n_over))
    torch.cuda.empty_cache()
    return errs


def tame_heads_to_features(model, x: torch.Tensor) -> None:
    """tame_heads with each head kernel scaled so that its term over the
    patches (the 3x3 conv of de_conv4_0's output in ``model``'s forward on
    ``x``, the first pass's for the iterative model) has the RMS of
    UNIFORM_HEAD_RMS, and the depth (or logit) bias raised by 2, in place:
    the fixed scale of tame_heads leaves 83% of the one-shot depth at 0 in
    eval mode at full depth (the features grow through the BatchNorms'
    initial statistics), where a parity check says little. As
    tests/test_torch_port_flagship.py tames the JAX model's heads."""
    feats = []
    hook = model.de_conv4_0.register_forward_hook(lambda m, i, o: feats.append(o.float()))
    with torch.inference_mode():
        model(x)
    hook.remove()
    sd = model.state_dict()
    for head, rms in UNIFORM_HEAD_RMS.items():
        w = sd[f"{head}.weight"]
        term = torch.nn.functional.conv2d(feats[0], w.float(), padding=1)
        sd[f"{head}.weight"] = w * (rms / term.square().mean().sqrt()).to(w.dtype)
    sd["pred.bias"] = sd["pred.bias"] + 2.0
    model.load_state_dict(sd)


def uniform_layout_phase(gpu: str, tables: dict, dev, g) -> dict:
    """uniform_layout: the three models' Python API at UNIFORM and the
    one-shot forward at UNIFORM_STRESS, seeded weights (seed 0), each run's
    kernel launches counted (zeroed just before it, read just after) and
    its result held to the same run on the plain versions. The forwards
    (heads tamed to their features, tame_heads_to_features): the one-shot
    depth in f32 (serve's bounds) and the bf16 recipe (serve_bf16's ratio to
    the plain versions' distance from f32), the iterative model's passes,
    the segmentation logits. One f32 train step at batch 8 (heads tamed as
    train_parity_vs_plain_on_card tames them) with that phase's float64 and
    one-ulp witnesses, on the batch and UNIFORM_POOL nudged copies of it:
    each witness statistic is the median over the pool (module constants).
    Returns the launches of each run and of all."""
    from omnifusion_torch.models import (
        SphericalFusion, SphericalFusionIterative, SphericalFusionSeg, init_weights,
    )

    spec, spec_s = tables[UNIFORM][0], tables[UNIFORM_STRESS][0]
    x = torch.rand(BATCH, *ERP, 3, device=dev, generator=g)
    launches, out = {}, {}

    def seeded(model):
        model = init_weights(model, 0).eval()
        tame_heads_to_features(model, x)
        return model

    def forward(name, model, want):
        """The model's forward on x, its launches (per_run ``want``
        expected), and the same forward on the plain versions."""
        zero_counts()
        with torch.inference_mode():
            kern = model(x)
            torch.cuda.synchronize()
            launches[name] = counts()
            with plain_versions():
                plain = model(x)
        if launches[name] != want:
            raise AssertionError(f"uniform {name} launches {launches[name]}, expected {want}")
        kern, plain = (kern, plain) if isinstance(kern, list) else ([kern], [plain])
        for k in kern:
            if not torch.isfinite(k).all():
                raise AssertionError(f"uniform {name}: non-finite output")
        return [k.float().cpu().numpy() for k in kern], [p.float().cpu().numpy() for p in plain]

    one = seeded(SphericalFusion(spec, device=dev))
    if tuple(one.transformer.pos_emb.shape[:2]) != (1, spec.n_patches):
        raise AssertionError(f"pos_emb {tuple(one.transformer.pos_emb.shape)}")
    (kern,), (plain,) = forward("oneshot_f32", one, per_run(1))
    if kern.shape != (BATCH, *ERP, 1) or (kern < 0).any():
        raise AssertionError(f"uniform depth: shape {kern.shape}, min {kern.min()}")
    out["oneshot_f32_vs_plain"] = rel_stats(kern, plain)
    one16 = SphericalFusion(spec, dtype=torch.bfloat16, merge_dtype=torch.float16, device=dev)
    one16.load_state_dict(one.state_dict())
    (kern16,), (plain16,) = forward("oneshot_bf16", one16.eval(), per_run(1))
    k_stats, p_stats = rel_stats(kern16, kern), rel_stats(plain16, kern)
    out["oneshot_bf16"] = {"recipe": "bf16 trunk + f16 merge", "kernels_vs_f32": k_stats,
                           "plain_vs_f32": p_stats, "kernels_vs_plain": rel_stats(kern16, plain16),
                           "ratio_bound": BF16_RATIO}
    del one, one16

    it = seeded(SphericalFusionIterative(spec, num_iters=ITERS, device=dev))
    kern_it, plain_it = forward("iterative", it, per_run(1, passes=ITERS))
    out["iterative_passes_vs_plain"] = [rel_stats(k, p) for k, p in zip(kern_it, plain_it)]
    del it

    seg = seeded(SphericalFusionSeg(spec, num_classes=SEG_CLASSES, device=dev))
    (logits,), (logits_plain,) = forward("segmentation", seg, per_run(1))
    out["segmentation_logits_vs_plain"] = rel_stats(logits, logits_plain)
    del seg, logits, logits_plain

    # one f32 train step at batch 8, on the batch and UNIFORM_POOL nudged
    # copies: in train mode (each draw's float64 run and one-ulp nudge of
    # the plain versions as its witnesses), then with the BatchNorms on the
    # running statistics the first step left
    tb = synthetic_batch(spec, TRAIN_BATCH, dev)
    model = init_weights(SphericalFusion(spec, device=dev), 0)
    sd0 = tame_heads(copy.deepcopy(model.state_dict()))
    draws = []
    zero_counts()
    with deterministic_cudnn():
        for seed in (None,) + UNIFORM_POOL:
            b = tb if seed is None else nudged(tb, seed)
            kern_s = loss_and_grads(model, b, sd0)
            if seed is None:
                sd1 = copy.deepcopy(model.state_dict())
                kern_rs = loss_and_grads(model, b, sd1, train=False)
            with plain_versions():
                plain_s = [loss_and_grads(model, bb, sd0) for bb in (b, nudged(b, 5))]
                f64 = loss_and_grads(*as_f64(model, b, sd0))
                model.float()
                if seed is None:
                    plain_rs = [loss_and_grads(model, bb, sd1, train=False) for bb in (b, nudged(b, 5))]
                    f64_rs = loss_and_grads(*as_f64(model, b, sd1), train=False)
                    model.float()
            draws.append(step_parity(kern_s, plain_s[0], f64, plain_s[1])[0])
            del kern_s, plain_s, f64
        torch.cuda.synchronize()
        launches["train_step"] = counts()
    del model
    torch.cuda.empty_cache()
    n_steps = len(draws) + 1
    if launches["train_step"] != per_run(0, n_steps):
        raise AssertionError(f"uniform train steps' launches {launches['train_step']}, "
                             f"expected {per_run(0, n_steps)}")
    par_rs, ok_rs = step_parity(kern_rs, plain_rs[0], f64_rs, plain_rs[1])
    pooled = {}
    for k in ("grad_rel_max", "grad_rel_median"):
        pooled[k] = {
            "ours_vs_f64": float(np.median([d["ours_vs_f64"][k] for d in draws])),
            "witness": float(np.median([max(d["ref_vs_f64"][k], d["ref_vs_ref_nudged"][k])
                                        for d in draws])),
            "ours_vs_ref": float(np.median([d[k] for d in draws])),
            "ref_vs_ref_nudged": float(np.median([d["ref_vs_ref_nudged"][k] for d in draws])),
        }
    loss_rel = max(d["loss_rel"] for d in draws)
    ok = (loss_rel < LOSS_TOL
          and all(v["ours_vs_f64"] <= F64_RATIO * v["witness"] for v in pooled.values())
          and pooled["grad_rel_max"]["ours_vs_ref"]
          <= ULP_RATIO * pooled["grad_rel_max"]["ref_vs_ref_nudged"])
    out["train_step"] = {
        "batch": TRAIN_BATCH, "heads": "tamed (tame_heads)",
        "precision": "f32 (tf32 off), cuDNN deterministic", "loss_tol": LOSS_TOL,
        "f64_ratio": F64_RATIO, "ulp_ratio": ULP_RATIO, "median_tol_running_stats": GRAD_TOL,
        "pool": {"draws": len(draws), "nudge_seeds": list(UNIFORM_POOL), "loss_rel_max": loss_rel,
                 "medians": pooled,
                 "per_draw": [{k: d[k] for k in ("loss_rel", "grad_rel_max", "grad_rel_worst")}
                              | {"ours_vs_f64_max": d["ours_vs_f64"]["grad_rel_max"],
                                 "ref_vs_f64_max": d["ref_vs_f64"]["grad_rel_max"],
                                 "ref_vs_ref_nudged_max": d["ref_vs_ref_nudged"]["grad_rel_max"]}
                              for d in draws]},
        "train_mode_batch": draws[0], "running_stats": par_rs,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del kern_rs, plain_rs, f64_rs

    stress = seeded(SphericalFusion(spec_s, device=dev))
    (kern_s6,), (plain_s6,) = forward("oneshot_f32_" + UNIFORM_STRESS.split(":")[1], stress,
                                      per_run(1))
    out["stress_oneshot_f32_vs_plain"] = rel_stats(kern_s6, plain_s6)
    del stress
    torch.cuda.empty_cache()

    total = {k: sum(run[k] for run in launches.values()) for k in next(iter(launches.values()))}
    emit({"phase": "uniform_layout", "layout": UNIFORM, "stress_layout": UNIFORM_STRESS,
          "batch": BATCH, "heads": "tamed to their features (forwards)",
          "precision": "f32 (tf32 off)", "gpu": gpu, "launches": launches,
          "launches_total": total, **out})
    for name in ("oneshot_f32_vs_plain", "segmentation_logits_vs_plain",
                 "stress_oneshot_f32_vs_plain"):
        assert_parity(out[name], f"uniform {name}")
        if out[name]["live_frac"] <= 0.5:
            raise AssertionError(f"uniform {name}: the heads are not live: {out[name]}")
    for key in ("median_rel", "q999_rel", "frac_rel_gt_0.05"):
        slack = BF16_SHARE if key == "frac_rel_gt_0.05" else 0.0
        if not k_stats[key] <= BF16_RATIO * p_stats[key] + slack:
            raise AssertionError(f"uniform bf16 recipe {key}: kernels {k_stats}, plain {p_stats}")
    for i, s in enumerate(out["iterative_passes_vs_plain"]):
        assert_parity(s, f"uniform iterative pass {i + 1} vs plain forward")
    if not (ok and ok_rs and par_rs["grad_rel_median"] < GRAD_TOL):
        raise AssertionError(f"uniform train step vs plain versions: {out['train_step']}")
    return {"runs": launches, "total": total}


def uniform_time_rows(gpu: str, tables: dict, t_q, launches: dict, dev, g, timer) -> dict:
    """The uniform layouts' time rows: per call at batch 2 (equi2pers, the
    quarter-resolution equi2pers, the merge, f32) or 8 (the merge's spread),
    the kernel beside its bound, its plain version and torch.sparse.mm on
    the same map, and the calls of its shape in uniform_layout's runs."""
    from omnifusion_torch.ops import quad_blend as qb
    from omnifusion_torch.ops.quad_blend import (
        quad_blend, quad_blend_plain, quad_spread, quad_spread_plain,
    )
    from omnifusion_torch.utils.profiling import blend_bound, blend_matrix, spread_bound

    n_erp = ERP[0] * ERP[1]
    # the calls on each table in uniform_layout's runs, whatever their
    # dtype: one equi2pers per forward (the iterative model's later passes
    # blend on the quarter-resolution tables), one merge per pass, one
    # spread per step; at UNIFORM four forwards (one-shot f32 and bf16,
    # iterative, segmentation) and the steps', at UNIFORM_STRESS one
    steps = launches["runs"]["train_step"]["quad_spread"]
    per_table = {
        (UNIFORM, "e2p"): 4 + steps, (UNIFORM, "merge"): 3 + ITERS + steps,
        (UNIFORM, "e2p_q"): ITERS - 1, (UNIFORM, "spread"): steps,
        (UNIFORM_STRESS, "e2p"): 1, (UNIFORM_STRESS, "merge"): 1, (UNIFORM_STRESS, "spread"): 0,
    }
    rows = {"quad_blend": [], "quad_spread": []}
    for layout, (_, t_e2p, t_p2e) in tables.items():
        tag = layout.split(":")[1]
        cases = [("e2p", torch.rand(BATCH, n_erp, 3, device=dev, generator=g), t_e2p, True),
                 ("merge", torch.rand(BATCH, 2, t_p2e.n_in, device=dev, generator=g), t_p2e,
                  False)]
        if layout == UNIFORM:
            cases.append(("e2p_q", torch.rand(BATCH, n_erp, 1, device=dev, generator=g) * 7 + 0.3,
                          t_q, True))
        for name, x, t, cl in cases:
            out = quad_blend(x, t, channel_last=cl)
            b_ms, b_by = blend_bound(x, t, out)
            plan = _plan(t.tiles, BATCH if cl else x.shape[0] * x.shape[1],
                         x.shape[2] if cl else 1, 4)
            w_csr = blend_matrix(t, x.dtype)
            dense = (x.permute(1, 0, 2) if cl else x.permute(2, 0, 1)).reshape(t.n_in, -1).contiguous()
            lib_err = (torch.sparse.mm(w_csr, dense) - (out.permute(1, 0, 2) if cl else out.permute(
                2, 0, 1)).reshape(t.n_out, -1)).abs().max().item()
            rows["quad_blend"].append({
                "case": f"{name}_{tag}", "layout": layout, "shape": list(x.shape), "batch": BATCH,
                "calls_in_uniform_layout": per_table[layout, name],
                "entries": t.tiles.entries, "footprint_per_output": t.tiles.footprint,
                "plan": plan,
                "ms": timer(lambda: quad_blend(x, t, channel_last=cl)),
                # the plan blend_plan's rule did not pick (ROADMAP §2 item 4)
                "ms_other_plan": timer(lambda: qb._blend_kernel(
                    x, t, cl, None, staged=not plan["staged"])),
                "plain_ms": timer(lambda: quad_blend_plain(x, t, channel_last=cl), iters=5,
                                  warmup=1),
                "library_ms": timer(lambda: torch.sparse.mm(w_csr, dense)),
                "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
            })
            del out, w_csr, dense
        cot = torch.rand(TRAIN_BATCH, 2, n_erp, device=dev, generator=g)
        t = t_p2e.vjp
        out = quad_spread(cot, t)
        s_ms, s_by = spread_bound(cot, t, out)
        wt_csr = spread_matrix(t)
        dense = cot.permute(2, 0, 1).reshape(t.n_out, -1).contiguous()
        lib_err = (torch.sparse.mm(wt_csr, dense) - out.permute(2, 0, 1).reshape(t.n_in, -1)
                   ).abs().max().item()
        split = kernel_split_ms(lambda: quad_spread(cot, t),
                                ("quad_spread_kernel", "quad_spread_heavy_kernel"))
        rows["quad_spread"].append({
            "case": f"merge_{tag}_b{TRAIN_BATCH}", "layout": layout, "shape": list(cot.shape),
            "calls_in_uniform_layout": per_table[layout, "spread"], "overflow": t.n_over,
            "heavy": t.heavy.numel(), "wide": t.n_wide,
            "ms": timer(lambda: quad_spread(cot, t)),
            "ms_light": split["quad_spread_kernel"], "ms_heavy": split["quad_spread_heavy_kernel"],
            "plain_ms": timer(lambda: quad_spread_plain(cot, t), iters=5, warmup=1),
            "library_ms": timer(lambda: torch.sparse.mm(wt_csr, dense)),
            "library_max_abs_err": lib_err, "bound_ms": s_ms, "bound_by": s_by,
        })
        del cot, out, wt_csr, dense
    for kernel, rs in rows.items():
        for r in rs:
            emit({"phase": "time", "kernel": kernel, "gpu": gpu, **r})
    torch.cuda.empty_cache()
    return rows


def uniform_phase(gpu: str, timer) -> dict:
    """The uniform layout (UNIFORM_LAYOUTS): tables_uniform, each kernel on
    its tables against its plain version, uniform_layout (the models), and
    the time rows. Returns the largest f32 differences from the plain
    versions, the launches and the time rows."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(14)
    tables, t_q = uniform_tables_phase(dev)
    errs = uniform_checks(tables, t_q, dev, g)
    launches = uniform_layout_phase(gpu, tables, dev, g)
    rows = uniform_time_rows(gpu, tables, t_q, launches, dev, g, timer)
    return {"errs": errs, "launches": launches, "rows": rows}


HEADS_BATCH = 64  # the batched serving cells' batch: 1152 maps of 32 x 128 x 128


def heads_phase(gpu: str, timer) -> dict:
    """The fused heads kernel (omnifusion_torch/ops/heads.py) at the
    flagship's patch, 2 and 14 outputs (depth; the segmentation model), f32
    and bf16, at BATCH and at HEADS_BATCH, on channels-last maps (the
    decoder's layout where autograd records nothing), and on one contiguous
    map, which the wrapper copies to channels-last: each call within
    rounding's bound of its plain version (heads_gap, at most 1), its outputs
    contiguous, the contiguous map's equal to its channels-last copy's; then
    each timed beside its bytes' bound and the library call on the same map
    (cuDNN's convolution and the activations). Returns the worst bound ratio
    and the time rows."""
    from omnifusion_torch.ops.heads import fused_heads, fused_heads_plain
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.utils.profiling import bound_ms as bound, nbytes

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(31)
    n_patches = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS).n_patches
    cases = [(b, n_out, dtype, "channels_last") for b in (BATCH, HEADS_BATCH) for n_out in (2, 14)
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append((BATCH, 2, torch.bfloat16, "contiguous"))
    worst, rows = 0.0, []
    for b, n_out, dtype, layout in cases:
        params = heads_params(n_out, g)
        act = "relu" if n_out == 2 else "none"
        x = torch.randn(b * n_patches, 32, PATCH, PATCH, device=dev, generator=g).to(dtype)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        x_in = x_cl if layout == "channels_last" else x
        case = f"{n_out}_outputs_{str(dtype)[6:]}_b{b}_{layout}"
        got = fused_heads(x_in, *params, act)
        torch.cuda.synchronize()
        gap = heads_gap(got, fused_heads_plain(x, *params, act), x, *params)
        same = x_in is x_cl or all(torch.equal(a, c) for a, c in zip(got, fused_heads(
            x_cl, *params, act)))
        emit({"phase": "check", "kernel": "fused_heads", "case": case, "shape": list(x.shape),
              "dtype": str(dtype), **gap, "bound_ratio_tol": 1.0, "channels_last_bits": same})
        if gap["bound_ratio"] > 1 or not same or not all(t.is_contiguous() for t in got):
            raise AssertionError(f"fused_heads {case}: {gap}, channels-last bits {same}")
        worst = max(worst, gap["bound_ratio"])
        b_ms, b_by = bound(nbytes(x, *got), 0)
        rows.append({"case": case, "shape": list(x.shape), "layout": layout,
                     "on_path": (b, dtype, layout) == (HEADS_BATCH, torch.bfloat16,
                                                       "channels_last"),
                     "ms": timer(lambda: fused_heads(x_in, *params, act)),
                     "library_ms": timer(lambda: fused_heads_plain(x_in, *params, act), iters=5),
                     "bound_ms": b_ms, "bound_by": b_by})
        emit({"phase": "time", "kernel": "fused_heads", "gpu": gpu, **rows[-1]})
        del x, x_cl, x_in, got
        torch.cuda.empty_cache()
    return {"bound_ratio": worst, "rows": rows}


# the decoder's five resizes of a pass at the batched serving cells' batch
# (HEADS_BATCH panoramas, 18 patch maps each): channels and input side; the
# bf16 recipe's first resize reads the f32 sum of layer4 and the tokens
DECODER_RESIZES = ((512, 4), (128, 8), (64, 16), (64, 32), (32, 64))


def channels_last_phase(gpu: str, timer) -> dict:
    """The NHWC form of the up2x kernel, the decoder's layout where
    autograd records nothing, at the HEADS_BATCH shapes (f32 and bf16): it
    gives its NCHW form's bits and the plain version's within UP2X_TOL /
    UP2X_BF16_RTOL, and is timed beside its bytes' bound, its NCHW form and
    the library call on the channels-last map (F.interpolate). Then a BATCH
    forward of each model without autograd (one-shot f32 and bf16,
    iterative and segmentation bf16) launches only the NHWC form, and the
    heads once a pass: the counter up2x.channels_last reads 5 a pass, as
    up2x.launches does, and fused_heads.launches 1."""
    import torch.nn.functional as F

    from omnifusion_torch.models import (
        SphericalFusion, SphericalFusionIterative, SphericalFusionSeg, init_weights,
    )
    from omnifusion_torch.ops import _build
    from omnifusion_torch.ops.upsample import up2x, up2x_plain
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.utils.profiling import recording, up2x_bound

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(41)
    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    maps = HEADS_BATCH * spec.n_patches
    rows = []
    for c, side in DECODER_RESIZES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.rand(maps, c, side, side, device=dev, generator=g).to(dtype)
            x_cl = x.contiguous(memory_format=torch.channels_last)
            case = f"{maps}x{c}x{side}x{side}_{str(dtype)[6:]}"
            got = up2x(x_cl)
            if not _build.channels_last(got):
                raise AssertionError(f"up2x {case}: the NHWC form returned {got.stride()}")
            same = torch.equal(got, up2x(x))
            check("up2x_nhwc", case, got, up2x_plain(x), *(
                (UP2X_TOL, 0.0) if dtype == torch.float32 else (1e-6, UP2X_BF16_RTOL)),
                nchw_bits=same)
            if not same:
                raise AssertionError(f"up2x {case}: the NHWC form differs from the NCHW form")
            b_ms, b_by = up2x_bound(x)
            rows.append({
                "case": case, "layout": "channels_last",
                "on_path": dtype == (torch.float32 if c == 512 else torch.bfloat16),
                "ms": timer(lambda: up2x(x_cl)), "nchw_ms": timer(lambda: up2x(x)),
                "plain_ms": timer(lambda: up2x_plain(x_cl), iters=5),
                "library_ms": timer(lambda: F.interpolate(
                    x_cl, scale_factor=2, mode="bilinear", align_corners=False)),
                "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "time", "kernel": "up2x_nhwc", "gpu": gpu, **rows[-1]})
            del x, x_cl, got
    torch.cuda.empty_cache()
    # a forward without autograd launches only up2x's NHWC form
    served = {}
    rgb = torch.rand(BATCH, *ERP, 3, device=dev, generator=g)
    for name, cls, kw, passes in (
            ("oneshot_f32", SphericalFusion, {}, 1),
            ("oneshot_bf16", SphericalFusion, {"dtype": torch.bfloat16}, 1),
            ("iterative_bf16", SphericalFusionIterative,
             {"dtype": torch.bfloat16, "num_iters": ITERS}, ITERS),
            ("seg_bf16", SphericalFusionSeg,
             {"dtype": torch.bfloat16, "num_classes": SEG_CLASSES}, 1)):
        model = init_weights(cls(spec, device=dev, **kw), 0).eval()
        zero_counts()
        with torch.inference_mode(), recording() as rec:
            model(rgb)
        torch.cuda.synchronize()
        launched = counts()
        served[name] = {"up2x.channels_last": rec.counters.get("up2x.channels_last", 0),
                        "up2x": launched["up2x"], "fused_heads": launched["fused_heads"]}
        want = {"up2x.channels_last": 5 * passes, "up2x": 5 * passes, "fused_heads": passes}
        emit({"phase": "channels_last_forward", "model": name, "batch": BATCH,
              "launches": served[name], "expected": want})
        if served[name] != want:
            raise AssertionError(f"{name}: {served[name]}, expected {want}")
        del model
        torch.cuda.empty_cache()
    return {"rows": rows, "served": served}


# the epilogue kernel's cases at a forward's maps: (case, channels, the
# patch's side over the map's, memory order, residual)
EPILOGUE_CASES = (("de_conv4_0", 32, 1, torch.channels_last, "none"),
                  ("layer1_conv2", 64, 4, torch.channels_last, "identity"),
                  ("layer2_downsample", 128, 8, torch.channels_last, "shortcut"),
                  ("mlp_points2", 64, 4, torch.contiguous_format, "none"))


def epilogue_case(gpu: str, case: str, shape: tuple, fmt, residual: str, g, timer) -> dict:
    """The epilogue kernel (omnifusion_torch/ops/epilogue.py) on a seeded
    bf16 map of ``shape`` in memory order ``fmt``, with no residual, the
    identity or a shortcut through its own scale and bias: one launch, the
    plain version's bits; timed beside its bytes' bound and the plain
    version (emitted as a time row, and returned)."""
    from omnifusion_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain
    from omnifusion_torch.utils.profiling import bound_ms, nbytes

    dev = torch.device(DEVICE)
    y = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16).contiguous(
        memory_format=fmt)
    z = None if residual == "none" else torch.randn_like(y)
    c = shape[1]
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    bias = torch.randn(c, device=dev, generator=g)
    z_scale, z_bias = ((torch.rand(c, device=dev, generator=g) + 0.5,
                        torch.randn(c, device=dev, generator=g))
                       if residual == "shortcut" else (None, None))
    before = conv_epilogue.launches
    got = conv_epilogue(y.clone(), scale, bias, z, z_scale, z_bias)
    want = conv_epilogue_plain(y.clone(), scale, bias, z, z_scale, z_bias)
    torch.cuda.synchronize()
    if conv_epilogue.launches != before + 1 or not torch.equal(got, want):
        raise AssertionError(f"conv_epilogue {case}: the kernel did not give the plain bits")
    del got, want
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(nbytes(y, y, z), 0)
    row = {"case": case, "shape": list(shape), "layout": str(fmt)[6:], "residual": residual,
           "ms": timer(lambda: conv_epilogue(y, scale, bias, z, z_scale, z_bias)),
           "plain_ms": timer(lambda: conv_epilogue_plain(y, scale, bias, z, z_scale, z_bias),
                             iters=5),
           "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "time", "kernel": "conv_epilogue", "gpu": gpu, **row})
    return row


def fold_phase(gpu: str, timer) -> dict:
    """The folded trunk (omnifusion_torch/models/layers.py: conv_bn_relu):
    at BATCH, a forward without autograd of each model (one-shot f32 and
    bf16, iterative and segmentation bf16; one set of weights, its
    BatchNorms calibrated on the batch in f32 by
    verify_kernels.calibrate_norms), runs 47 (iterative 94) convolutions
    folded and 44 (88) epilogue kernels (the downsamples join their block's),
    folds each once and nothing on the second forward, and gives
    the unfolded forward's outputs (the same model with the fold off): f32
    within FOLD_F32_GAP, bf16 no farther from the f32 forward than
    FOLD_BF16_RATIO times the unfolded bf16 one. Then the epilogue kernel
    (omnifusion_torch/ops/epilogue.py) at four of the HEADS_BATCH forward's
    maps gives its plain version's bits and is timed beside its bytes' bound
    and the plain version, and the one-shot bf16 forward at HEADS_BATCH is
    timed folded and unfolded."""
    import omnifusion_torch.models.layers as ly
    from omnifusion_torch.models import (
        SphericalFusion, SphericalFusionIterative, SphericalFusionSeg, init_weights,
    )
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.utils.profiling import recording

    dev = torch.device(DEVICE)
    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    g = torch.Generator(device=dev).manual_seed(43)
    rgb = torch.rand(BATCH, *ERP, 3, device=dev, generator=g)
    models = {"oneshot": (SphericalFusion, {}, 47, 47),
              "iterative": (SphericalFusionIterative, {"num_iters": ITERS}, 94, 49),
              "seg": (SphericalFusionSeg, {"num_classes": SEG_CLASSES}, 47, 47)}

    def build(kind, dtype):
        """The model in ``dtype`` with the f32 model's weights, calibrated on
        the batch in f32, and the f32 model."""
        cls, kw, _, _ = models[kind]
        f32 = calibrate_norms(init_weights(cls(spec, device=dev, **kw), 0), rgb)
        if dtype is None:
            return f32, f32
        model = cls(spec, dtype=dtype, device=dev, **kw)
        model.load_state_dict(f32.state_dict())
        return model.eval(), f32

    def forward(model, rgb, fold=True):
        saved = ly._folds
        if not fold:
            ly._folds = lambda bn, x: False
        try:
            with torch.inference_mode(), recording() as rec:
                out = model(rgb)
        finally:
            ly._folds = saved
        torch.cuda.synchronize()
        return [o.double() for o in (out if isinstance(out, list) else [out])], rec.counters

    def gap(a, b):
        return float((a - b).norm() / b.norm())

    rows = []
    for kind, dtype in (("oneshot", None), ("oneshot", torch.bfloat16),
                        ("iterative", torch.bfloat16), ("seg", torch.bfloat16)):
        _, _, convs, folds = models[kind]
        model, f32_model = build(kind, dtype)
        seen = []
        for _ in range(2):
            got, counters = forward(model, rgb)
            seen.append({k: counters.get(k, 0)
                         for k in ("conv_fold.convs", "conv_fold.folds", "conv_epilogue.launches")})
        want, _ = forward(model, rgb, fold=False)
        f32 = forward(f32_model, rgb, fold=False)[0]
        del model, f32_model
        gaps = [gap(a, b) for a, b in zip(got, want)]
        to_f32 = [(gap(a, c), gap(b, c)) for a, b, c in zip(got, want, f32)]
        row = {"model": kind, "dtype": "bf16" if dtype else "f32", "batch": BATCH,
               "counters": seen, "gap_to_unfolded": gaps, "gap_to_f32": to_f32}
        emit({"phase": "fold", "gpu": gpu, **row})
        rows.append(row)
        launches = 44 * (convs // 47)  # a pass: 47 convolutions, 3 of them downsamples
        if seen != [{"conv_fold.convs": convs, "conv_fold.folds": n, "conv_epilogue.launches":
                     launches} for n in (folds, 0)]:
            raise AssertionError(f"fold {kind}: counters {seen}, expected {convs} folded "
                                 f"convolutions, {launches} epilogue launches, {folds} then 0 "
                                 "folds")
        if dtype is None and max(gaps) >= FOLD_F32_GAP:
            raise AssertionError(f"fold {kind} f32: {gaps} against the unfolded forward")
        if dtype is not None and any(a > FOLD_BF16_RATIO * b for a, b in to_f32):
            raise AssertionError(f"fold {kind} bf16: {to_f32} (folded, unfolded) to the f32 one")
        del got, want, f32
        torch.cuda.empty_cache()
    # the epilogue kernel at the b64 forward's maps: the plain version's bits,
    # timed beside its bytes' bound and the plain version
    maps = HEADS_BATCH * spec.n_patches
    kernel_rows = [epilogue_case(gpu, case, (maps, c, PATCH // d, PATCH // d), fmt, residual, g,
                                 timer)
                   for case, c, d, fmt, residual in EPILOGUE_CASES]
    torch.cuda.empty_cache()
    model = build("oneshot", torch.bfloat16)[0]
    x = torch.rand(HEADS_BATCH, *ERP, 3, device=dev, generator=g)
    with torch.inference_mode():
        folded_ms = timer(lambda: model(x), iters=10)
        saved, ly._folds = ly._folds, lambda bn, x: False
        try:
            unfolded_ms = timer(lambda: model(x), iters=10)
        finally:
            ly._folds = saved
    time_row = {"model": "oneshot", "dtype": "bf16", "batch": HEADS_BATCH,
                "folded_ms": folded_ms, "unfolded_ms": unfolded_ms}
    emit({"phase": "time", "kernel": "folded_forward", "gpu": gpu, **time_row})
    del model, x
    torch.cuda.empty_cache()
    return {"rows": rows, "kernel_rows": kernel_rows, "time": time_row}


# the README's patch 256 (benchmark/configs/oneshot_s2d3d_p256.json): its
# tables' blend plans at the batched serving cells' batch (HEADS_BATCH), the
# shapes its decoder's last stages meet, and its serving forward's launches
P256 = 256
P256_LAUNCHES = {"up2x.channels_last": 5, "conv_epilogue.launches": 44,
                 "fused_heads.launches": 1, "quad_blend.staged": 1, "quad_blend.global": 1,
                 "up_proj.calls": 1}


def p256_phase(gpu: str, timer) -> dict:
    """The one-shot model at patch 256 (512x1024, fov 80, nrows 4: 18
    patches of 256x256, a 2048-wide token folded back through up_proj).
    Each kernel at its HEADS_BATCH shapes against its plain version: the
    merge (f16, 128 rows; footprint past STAGE_MAX_FOOTPRINT: the rule
    gathers from global memory) and the e2p (bf16 stored bf16, 64 batches of
    3; within it: the rule stages), each on the rule's plan and on the other
    (``staged=``); the heads (bf16, 2 outputs) on the channels-last (1152,
    32, 256, 256) map; up2x's NHWC form at 32 channels, 128 -> 256, bf16;
    the conv epilogue on the forward's channels-last maps (EPILOGUE_CASES).
    Each timed beside its bound, the plain version and the library call.
    The BATCH forward's fold and the up_proj sum (p256_fold_and_fuse).
    Then a bf16 serving forward (f16 merge) at BATCH and at HEADS_BATCH
    launches P256_LAUNCHES and hands the heads a channels-last map (no
    copy); the HEADS_BATCH forward is timed, with its peak memory; and two
    panoramas go through cli/infer.py with --patchsize 256 --bf16."""
    import torch.nn.functional as F

    import omnifusion_torch.models.spherical_fusion as sf
    from omnifusion_torch.cli import infer
    from omnifusion_torch.models import SphericalFusion, init_weights
    from omnifusion_torch.ops import _build
    from omnifusion_torch.ops import quad_blend as qb
    from omnifusion_torch.ops.heads import fused_heads, fused_heads_plain
    from omnifusion_torch.ops.upsample import up2x, up2x_plain
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
    from omnifusion_torch.utils.profiling import (
        blend_bound, bound_ms as bound, nbytes, recording, up2x_bound,
    )

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(45)
    spec = ProjectionSpec.create(ERP, P256, (FOV, FOV), NROWS)
    maps = HEADS_BATCH * spec.n_patches
    t0 = time.perf_counter()
    t_e2p, t_p2e = equi2pers_tables(spec, dev), pers2equi_tables(spec, dev)
    emit({"phase": "p256_tables", "seconds": time.perf_counter() - t0,
          "e2p": {"footprint_per_output": t_e2p.tiles.footprint, "pitch": t_e2p.tiles.pitch,
                  **_plan(t_e2p.tiles, HEADS_BATCH, 3, 2)},
          "merge": {"footprint_per_output": t_p2e.tiles.footprint, "pitch": t_p2e.tiles.pitch,
                    "tail_entries": t_p2e.n_tail, **_plan(t_p2e.tiles, 2 * HEADS_BATCH, 1, 2)}})
    rows = []
    for name, tables, cl, dtype, out_dtype in (
            ("merge", t_p2e, False, torch.float16, None),
            ("e2p", t_e2p, True, torch.bfloat16, torch.bfloat16)):
        shape = (HEADS_BATCH, tables.n_in, 3) if cl else (HEADS_BATCH, 2, tables.n_in)
        x = torch.rand(shape, device=dev, generator=g).to(dtype)
        want = qb.quad_blend_plain(x, tables, cl, out_dtype)
        rule = qb.blend_plan(tables.tiles, shape[0] if cl else shape[0] * 2, 3 if cl else 1,
                             x.element_size())[0]
        for staged in (rule, not rule):
            with recording() as rec:
                got = qb._blend_kernel(x, tables, cl, out_dtype, staged=staged)
            plan = "staged" if staged else "global"
            tol = (BLEND_TOL, 0.0) if out_dtype is None else (1e-6, 2.0**-7)
            check("quad_blend", f"p256_{name}_{plan}_b{HEADS_BATCH}", got, want, *tol,
                  rule=staged == rule, footprint=tables.tiles.footprint)
            if {k: v for k, v in rec.counters.items() if k.startswith("quad_blend.")} != {
                    f"quad_blend.{plan}": 1}:
                raise AssertionError(f"p256 {name} {plan}: counters {rec.counters}")
            b_ms, b_by = blend_bound(x, tables, got)
            rows.append({"case": f"p256_{name}_b{HEADS_BATCH}", "plan": plan,
                         "rule": staged == rule, "dtype": str(dtype)[6:],
                         "ms": timer(lambda: qb._blend_kernel(x, tables, cl, out_dtype,
                                                              staged=staged)),
                         "plain_ms": timer(lambda: qb.quad_blend_plain(x, tables, cl, out_dtype),
                                           iters=3),
                         "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "time", "kernel": "quad_blend", "gpu": gpu, **rows[-1]})
        del x, want, got
    torch.cuda.empty_cache()

    params = heads_params(2, g)
    x = torch.randn(maps, 32, P256, P256, device=dev, generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    got = fused_heads(x, *params)
    torch.cuda.synchronize()
    gap = heads_gap(got, fused_heads_plain(x, *params), x, *params)
    emit({"phase": "check", "kernel": "fused_heads", "case": f"p256_2_outputs_bf16_b{HEADS_BATCH}",
          "shape": list(x.shape), "dtype": "bfloat16", **gap, "bound_ratio_tol": 1.0})
    if gap["bound_ratio"] > 1:
        raise AssertionError(f"fused_heads at patch 256: {gap}")
    b_ms, b_by = bound(nbytes(x, *got), 0)
    rows.append({"case": f"p256_heads_2_outputs_bf16_b{HEADS_BATCH}", "shape": list(x.shape),
                 "ms": timer(lambda: fused_heads(x, *params)),
                 "library_ms": timer(lambda: fused_heads_plain(x, *params), iters=5),
                 "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "time", "kernel": "fused_heads", "gpu": gpu, **rows[-1]})
    del x, got
    torch.cuda.empty_cache()

    x = torch.rand(maps, 32, P256 // 2, P256 // 2, device=dev, generator=g).to(torch.bfloat16)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    got = up2x(x_cl)
    same = torch.equal(got, up2x(x))
    check("up2x_nhwc", f"p256_{maps}x32x128x128_bfloat16", got, up2x_plain(x), 1e-6,
          UP2X_BF16_RTOL, nchw_bits=same)
    if not same or not _build.channels_last(got):
        raise AssertionError("up2x at patch 256: the NHWC form differs from the NCHW form")
    b_ms, b_by = up2x_bound(x)
    rows.append({"case": f"p256_up2x_nhwc_{maps}x32x128x128_bf16",
                 "ms": timer(lambda: up2x(x_cl)), "nchw_ms": timer(lambda: up2x(x)),
                 "plain_ms": timer(lambda: up2x_plain(x_cl), iters=5),
                 # the library's NHWC form refuses 2^31 outputs: two calls of half
                 "library_ms": timer(lambda: [F.interpolate(
                     half, scale_factor=2, mode="bilinear", align_corners=False)
                     for half in x_cl.chunk(2)]),
                 "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "time", "kernel": "up2x_nhwc", "gpu": gpu, **rows[-1]})
    del x, x_cl, got
    torch.cuda.empty_cache()

    # the epilogue kernel at the channels-last maps of the b64 forward: the
    # last decoder stage's map has 2.4e9 elements, past 32-bit indices
    rows += [epilogue_case(gpu, f"p256_{case}", (maps, c, P256 // d, P256 // d), fmt, residual,
                           g, timer)
             for case, c, d, fmt, residual in EPILOGUE_CASES if fmt == torch.channels_last]
    torch.cuda.empty_cache()

    # the serving forward: launches, the heads' map, the b64 time and peak
    rgb = torch.rand(HEADS_BATCH, *ERP, 3, device=dev, generator=g)
    f32 = calibrate_norms(init_weights(SphericalFusion(spec, device=dev), 0), rgb[:BATCH])
    model = SphericalFusion(spec, dtype=torch.bfloat16, merge_dtype=torch.float16, device=dev)
    model.load_state_dict(f32.state_dict())
    model.eval()
    fused = p256_fold_and_fuse(gpu, model, f32, rgb[:BATCH], g)
    del f32
    heads_in = []
    kernel = sf.fused_heads
    sf.fused_heads = lambda x, *a: (heads_in.append(_build.channels_last(x)), kernel(x, *a))[1]
    served = {}
    try:
        for b in (BATCH, HEADS_BATCH):
            heads_in.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode(), recording() as rec:
                depth = model(rgb[:b])
            torch.cuda.synchronize()
            got = {k: rec.counters.get(k, 0) for k in P256_LAUNCHES}
            served[b] = {"launches": got, "heads_channels_last": list(heads_in),
                         "finite": bool(torch.isfinite(depth).all()),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            emit({"phase": "p256_forward", "batch": b, **served[b], "expected": P256_LAUNCHES})
            if got != P256_LAUNCHES or heads_in != [True] or not served[b]["finite"]:
                raise AssertionError(f"p256 forward at b{b}: {served[b]}")
    finally:
        sf.fused_heads = kernel
    with torch.inference_mode():
        forward_ms = timer(lambda: model(rgb), iters=10)
    emit({"phase": "time", "kernel": "p256_forward", "gpu": gpu, "batch": HEADS_BATCH,
          "ms": forward_ms, "panoramas_per_s": 1e3 * HEADS_BATCH / forward_ms})
    del model, rgb, depth
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        inputs = os.path.join(tmp, "panos")
        os.makedirs(inputs)
        rng = np.random.default_rng(2)
        for i in range(BATCH):
            np.save(os.path.join(inputs, f"pano{i}.npy"), rng.random((*ERP, 3), dtype=np.float32))
        args = infer.build_parser().parse_args(
            ["--input", inputs, "--save_path", os.path.join(tmp, "out"), "--seed", "0",
             "--device", DEVICE, "--batch", str(BATCH), "--erp_size", f"{ERP[0]},{ERP[1]}",
             "--patchsize", str(P256), "--fov", str(FOV), "--nrows", str(NROWS), "--bf16",
             "--merge_dtype", "f16"])
        depths = [np.load(w) for w in infer.run_infer(args)]
    ok = len(depths) == BATCH and all(d.shape == ERP and np.isfinite(d).all() for d in depths)
    emit({"phase": "p256_infer", "written": len(depths), "ok": ok})
    if not ok:
        raise AssertionError("cli/infer.py at patch 256 wrote no finite depth of the ERP's size")
    return {"rows": rows, "fused": fused, "served": served, "forward_ms": forward_ms}


# the up_proj sum on a channels-last layer4 against the same sum on its
# NCHW copy (the order the CPU tests hold to the JAX package), by relative
# L2: f32 (TF32 off) and bf16 (up_proj's and the sum's roundings to bf16 may
# land one ulp apart where cuDNN sums the two orders differently)
FUSE_GAP = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def p256_fold_and_fuse(gpu: str, model, f32_model, rgb, g) -> dict:
    """At patch 256: the bf16 serving forward of ``rgb`` folded, no farther
    from the f32 forward (``f32_model``, unfolded) than FOLD_BF16_RATIO times
    the same model unfolded, as fold_phase holds patch 128; and each model's
    ``fuse`` (the transformer and the up_proj sum) on a seeded channels-last
    layer4 of the batch: a channels-last sum within FUSE_GAP of the sum on
    the NCHW copy, which comes out NCHW."""
    import omnifusion_torch.models.layers as ly
    from omnifusion_torch.ops import _build

    def forward(m, fold=True):
        saved = ly._folds
        if not fold:
            ly._folds = lambda bn, x: False
        try:
            with torch.inference_mode():
                return m(rgb).double()
        finally:
            ly._folds = saved

    def gap(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    f32 = forward(f32_model, fold=False)
    to_f32 = (gap(forward(model), f32), gap(forward(model, fold=False), f32))
    b = rgb.shape[0]
    fuse = {}
    for name, m in (("f32", f32_model), ("bf16", model)):
        dtype = m.dtype or torch.float32
        l4 = torch.randn(b * m.n_patches, 512, P256 // 32, P256 // 32, device=rgb.device,
                         generator=g).to(dtype)
        l4_cl = l4.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            got, want = m.fuse(l4_cl, b), m.fuse(l4, b)
        fuse[name] = {"gap": gap(got, want), "tol": FUSE_GAP[dtype],
                      "channels_last": _build.channels_last(got),
                      "nchw": want.is_contiguous() and not _build.channels_last(want)}
    row = {"batch": b, "gap_to_f32": to_f32, "fold_bf16_ratio": FOLD_BF16_RATIO, "fuse": fuse}
    emit({"phase": "p256_fold_and_fuse", "gpu": gpu, **row})
    if to_f32[0] > FOLD_BF16_RATIO * to_f32[1]:
        raise AssertionError(f"p256 fold bf16: {to_f32} (folded, unfolded) to the f32 forward")
    for name, f in fuse.items():
        if not (f["gap"] <= f["tol"] and f["channels_last"] and f["nchw"]):
            raise AssertionError(f"p256 up_proj sum {name}: {f}")
    return row


def multi_device_phases(gpu: str, f64_witness: dict) -> dict:
    """ddp_gloo2, mesh_model and mesh1 (see the comment above DDP_RANKS);
    ``f64_witness``: the float64 steps of the train parity phases, by
    model. Returns the kernels' launches of each path for the kernels
    line."""
    from omnifusion_torch import parallel
    from omnifusion_torch.cli import infer, train, train_sem
    from omnifusion_torch.cli.common import build_model
    from omnifusion_torch.parallel.launch import spawn
    from omnifusion_torch.training import create_train_state, train_step
    from omnifusion_torch.utils.profiling import time_ms

    dev = torch.device(DEVICE)
    launches = {}
    # ---- ddp_gloo2: the one-process references first, on the card alone ----
    refs = one_process_refs(dev)
    t0 = time.perf_counter()
    ranks = spawn(ddp_gloo2_rank, DDP_RANKS, (), lambda r: f"{DEVICE}:0", "gloo", 600)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    bn_ok = all(max(v for k, v in r["batchnorm"].items() if k != "own_statistics_out") < BN_TOL
                and r["batchnorm"]["own_statistics_out"] > 100 * BN_TOL for r in ranks)
    result = {kind: mesh_parity(kind, ranks, refs, f64_witness, ITERS if kind == "iterative" else 1)
              for kind in DDP_KINDS}
    ok = (bn_ok and all(r["probe"]["ok"] for r in ranks)
          and all(r["ok"] for r in result.values()))
    launches["ddp_gloo2_per_rank"] = r0["oneshot"]["launches"]
    emit({"phase": "ddp_gloo2", "gpu": gpu, "ranks": DDP_RANKS, "backend": "gloo",
          "device": f"{DEVICE}:0 shared", "batch": f"{TRAIN_BATCH} global, "
          f"{TRAIN_BATCH // DDP_RANKS} per rank", "probe": [r["probe"] for r in ranks],
          "batchnorm_vs_cudnn": [r["batchnorm"] for r in ranks], "bn_tol": BN_TOL, **result,
          "step_wall_ms_per_rank": [r["step_wall_ms"] for r in ranks],
          "step_wall_ms_note": "not a scaling number: two ranks share one card and gloo "
                               "stages CUDA tensors through the host",
          "max_memory_allocated_bytes_per_rank": [r["max_memory_allocated_bytes"] for r in ranks],
          "seconds_with_spawn": spawn_s})
    if not ok:
        raise AssertionError("ddp_gloo2: see its line")
    del ranks, r0

    # ---- mesh_model: the mesh's model axis, on the same references ----
    for shape, lc in mesh_model_phase(gpu, refs, f64_witness).items():
        launches[f"mesh_model_{shape}_per_rank"] = lc
    del refs

    # ---- mesh1: the entry points with --mesh 1 ----
    flag = ["--erp_size", f"{ERP[0]},{ERP[1]}", "--patchsize", str(PATCH), "--fov", str(FOV),
            "--nrows", str(NROWS), "--seed", "0", "--device", DEVICE]
    n_train = TRAIN_STEPS * TRAIN_BATCH
    val_forwards = -(-n_train // TRAIN_BATCH)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        argv = flag + ["--dataset", "synthetic", "--synthetic_size", str(n_train), "--epochs",
                       "1", "--batch", str(TRAIN_BATCH), "--workers", "4", "--mesh", "1",
                       "--save_path", os.path.join(tmp, "train")]
        zero_counts()
        history = train.run_training(train.build_parser().parse_args(argv))
        launches["mesh1"] = counts()
        ckpts = sorted(os.listdir(os.path.join(tmp, "train", "ckpt")))
        ckpt = torch.load(os.path.join(tmp, "train", "ckpt", "latest.pt"), map_location="cpu",
                          weights_only=True)
        want = per_run(val_forwards, TRAIN_STEPS)
        train_ok = (history["steps"] == TRAIN_STEPS and np.isfinite(history["train_loss"]).all()
                    and launches["mesh1"] == want and ckpts == ["best.pt", "latest.pt"]
                    and not any(k.startswith("module.") for k in ckpt["model"])
                    and not parallel.is_distributed())
        emit({"phase": "mesh1", "entry": "cli.train", "batch": TRAIN_BATCH,
              "steps": history["steps"], "train_loss": history["train_loss"],
              "val": history["val"], "checkpoints": ckpts, "launches": launches["mesh1"],
              "launches_expected": want})
        # cli.train_sem: its 32 synthetic panoramas at batch 16, 2 steps
        argv = flag + ["--dataset", "synthetic", "--epochs", "1", "--batch",
                       str(2 * TRAIN_BATCH), "--num_classes", str(SEG_CLASSES), "--workers",
                       "4", "--mesh", "1", "--save_path", os.path.join(tmp, "sem")]
        zero_counts()
        hist_sem = train_sem.main(argv)
        sem_launches = counts()
        want_sem = per_run(-(-SEM_VAL_SET // (2 * TRAIN_BATCH)), SEM_TRAIN_SET // (2 * TRAIN_BATCH))
        sem_ok = (np.isfinite(hist_sem["train_loss"]).all() and 0 <= hist_sem["miou"][0] <= 1
                  and sem_launches == want_sem)
        emit({"phase": "mesh1", "entry": "cli.train_sem", "batch": 2 * TRAIN_BATCH,
              "train_loss": hist_sem["train_loss"], "miou": hist_sem["miou"],
              "launches": sem_launches, "launches_expected": want_sem})
        # cli.test on 4 synthetic panoramas, and cli.infer on 4 panoramas,
        # each with --mesh 1 and without a mesh, from tamed seeded weights
        path = os.path.join(tmp, "tamed.pt")
        torch.save(flagship_model("oneshot", "cpu").state_dict(), path)
        evals = {m: eval_run(flag + ["--dataset", "synthetic", "--synthetic_size", "4",
                                     "--batch", str(BATCH), "--checkpoint", path,
                                     "--visualize_interval", "0", "--mesh", m,
                                     "--save_path", os.path.join(tmp, f"eval_{m}")])
                 for m in ("1", "none")}
        gaps = metric_gaps(evals["1"][0], evals["none"][0])
        rng = np.random.default_rng(3)
        os.makedirs(os.path.join(tmp, "panos"))
        for i in range(N_PANOS):
            np.save(os.path.join(tmp, "panos", f"p{i}.npy"),
                    rng.random((*ERP, 3), dtype=np.float32))
        depth = {}
        for m in ("1", "none"):
            a = infer.build_parser().parse_args(flag + [
                "--input", os.path.join(tmp, "panos"), "--checkpoint", path, "--batch",
                str(BATCH), "--mesh", m, "--save_path", os.path.join(tmp, f"infer_{m}")])
            with deterministic_cudnn():
                depth[m] = [np.load(f) for f in infer.run_infer(a)]
        infer_equal = all(np.array_equal(a, b) for a, b in zip(depth["1"], depth["none"]))
        emit({"phase": "mesh1", "entry": "cli.test and cli.infer", "eval_metrics_mesh1":
              evals["1"][0], "eval_metric_gaps": gaps, "eval_tol": 1e-4,
              "eval_launches": evals["1"][2], "infer_panoramas": len(depth["1"]),
              "infer_bitwise_equal": infer_equal})
        if not (train_ok and sem_ok and max(gaps.values()) < 1e-4 and infer_equal
                and len(depth["1"]) == N_PANOS):
            raise AssertionError("mesh1: see its lines")

    # ---- the cost of --mesh 1: the one-shot train step at batch 8 with DDP
    # and the global BatchNorm over a one-rank nccl group, against the same
    # step without a mesh, f32, TF32 and the bf16 recipe, interleaved ----
    tb = flagship_batch("oneshot", dev)
    times = {}
    for label, tf32, extra in (("f32", False, []), ("tf32", True, []),
                               ("bf16", False, ["--bf16", "--merge_dtype", "f16"])):
        torch.backends.cudnn.allow_tf32 = tf32
        for mesh in ("none", "1"):
            a = train.build_parser().parse_args(flag + extra + ["--mesh", mesh])
            model = build_model(a, dev)
            state = create_train_state(model)
            if mesh == "1":
                parallel.init_process_group(0, 1, dev, store=torch.distributed.HashStore())
                state.model = parallel.wrap(model, dev)
            try:
                torch.cuda.reset_peak_memory_stats()
                ms = time_ms(lambda: train_step(state, tb), dev, 5, 2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    train_step(state, tb)
                torch.cuda.synchronize()
                times[f"{label}_{'mesh1' if mesh == '1' else 'no_mesh'}"] = {
                    "device_ms": ms, "wall_ms": (time.perf_counter() - t0) * 1e3 / 5,
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
            finally:
                parallel.destroy()
            del state, model
            torch.cuda.empty_cache()
    pin_f32()
    emit({"phase": "mesh1_train_step", "gpu": gpu, "batch": TRAIN_BATCH, "erp": list(ERP),
          "patch": PATCH, "note": "mesh1: DDP + GlobalBatchNorm2d over a one-rank nccl group",
          **times})
    return launches


# ---- the measurement tools (omnifusion_torch/tools): bench_train with MFU,
# --remat, bench_sweep, sol_model, eval_merge_dtype, verify_kernels ----
# bench_sweep's batches and modes, and the row held to bench.py's time at
# that batch; sol_model's batches (the time rows' and bench.py's largest);
# eval_merge_dtype's protocol (its defaults)
SWEEP_BATCHES, SWEEP_MODES, SWEEP_CHECK_BATCH = "8,64", "f32,f16_merge", 64
SOL_BATCHES = (BATCH, TRAIN_BATCH, 256)
STEP_MS_TOL, SWEEP_MS_TOL, FLOOR_TOL = 0.10, 0.15, 1e-12
EVAL_MERGE_STEPS, EVAL_MERGE_ARGS = 150, ["--train_erp", "256,512", "--eval_erps",
                                          "256,512;512,1024", "--patch", "128"]


def sol_time_case(kernel: str, stage: str, batch: int) -> tuple[str, str]:
    """The time row (kernel, case) that holds the same call as a sol_model
    row at ``batch``."""
    if kernel == "quad_blend":
        name = {"equi2pers": "e2p_bf16", "merge": "merge_f16"}[stage]
        return kernel, name if batch == BATCH else f"{name}_b{batch}"
    if kernel == "quad_spread":
        return kernel, f"merge_f32_b{batch}"
    shape_dtype = stage.split()[1]  # "<shape>_<dtype>", the upsample's input
    if kernel == "up2x":
        return kernel, shape_dtype
    shape, dtype = shape_dtype.rsplit("_", 1)
    return kernel, shape + ("_bf16" if dtype == "bfloat16" else "")


def measurement_tool_phases(gpu: str, rows: dict, benches: dict, step_ms: float,
                            bf16_step_ms: float) -> dict:
    """bench_train, remat, bench_sweep, sol_model, eval_merge_dtype and
    verify_kernels, each through its main() in this process with its kernel
    launches counted. ``rows``: the time phase's rows, by kernel;
    ``benches``: bench.py's results by batch; ``step_ms``: the train_step
    phase's f32 (TF32 off) device ms; ``bf16_step_ms``: train_bf16's.
    Returns the launches of each phase for the kernels line."""
    from omnifusion_torch.models import SphericalFusion, init_weights
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.tools import (
        bench_sweep, bench_train, eval_merge_dtype, sol_model, verify_kernels,
    )
    from omnifusion_torch.training import forward_loss
    from omnifusion_torch.utils.profiling import count_flops

    dev = torch.device(DEVICE)
    launches = {}
    flag = ["--erp", f"{ERP[0]},{ERP[1]}", "--patch", f"{PATCH},{PATCH}", "--nrows", str(NROWS),
            "--batch", str(TRAIN_BATCH), "--device", DEVICE]

    def tool(main, argv):
        zero_counts()
        out = json.loads(run_tool(main, argv)[-1])
        return out, counts()

    # ---- bench_train: f32 (TF32 off), TF32, the bf16 recipe, iterative f32 ----
    results = {}
    for label, tf32, extra in (("f32", False, []), ("tf32", True, []),
                               ("bf16", False, ["--bf16", "--merge_dtype", "f16"]),
                               ("iterative_f32", False, ["--model", "iterative"])):
        torch.backends.cudnn.allow_tf32 = tf32
        out, lc = tool(bench_train.main, flag + extra)
        pin_f32()
        passes = ITERS if label.startswith("iterative") else 1
        want = per_run(out["forward"]["calls"], out["train"]["calls"], passes)
        results[label] = out
        emit({"phase": "bench_train", "run": label, "gpu": gpu, "precision": out["precision"],
              **{k: {kk: vv for kk, vv in out[k].items() if kk != "flops_by_op"}
                 for k in ("forward", "train")},
              "params": out["params"], "launches": lc, "launches_expected": want})
        if out["oom"] or lc != want or not np.isfinite(out["train"]["loss"]):
            raise AssertionError(f"bench_train {label}: {out['oom']}, launches {lc}")
        launches[f"bench_train_{label}"] = lc
    # the f32 step's FLOPs against the CPU test's count (forward_loss and
    # its backward) at the flagship: at batch 1 and 2, the per-panorama part
    # and the once-per-batch geometric embedding, then at TRAIN_BATCH
    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    model = init_weights(SphericalFusion(spec, device=dev), 0)
    formula = {}
    for b in (1, 2):
        batch = {k: v[:b] for k, v in synthetic_batch(spec, 2, dev).items()}
        formula[b] = count_flops(lambda: forward_loss(model, batch)[0].backward())["total"]
    del model
    torch.cuda.empty_cache()
    per_pano = formula[2] - formula[1]
    want_flops = formula[1] + (TRAIN_BATCH - 1) * per_pano
    got_flops = results["f32"]["train"]["gflop"] * 1e9
    step_gap = abs(results["f32"]["train"]["device_ms"] / step_ms - 1)
    emit({"phase": "bench_train", "check": "flops and time", "gpu": gpu,
          "step_gflop": got_flops / 1e9, "formula_gflop_b1": formula[1] / 1e9,
          "formula_gflop_per_panorama": per_pano / 1e9,
          "formula_gflop_train_batch": want_flops / 1e9,
          "train_batch_times_b1_gflop": TRAIN_BATCH * formula[1] / 1e9,
          "step_device_ms": results["f32"]["train"]["device_ms"],
          "train_step_phase_device_ms": step_ms, "gap": step_gap, "tol": STEP_MS_TOL})
    if round(got_flops) != want_flops or step_gap > STEP_MS_TOL:
        raise AssertionError(f"bench_train f32: {got_flops} FLOPs against {want_flops}, "
                             f"{step_gap} from the train_step phase")

    # ---- remat: the one-shot b8 f32 step with --remat: its peak memory,
    # and its parity with the step without it ----
    out, lc = tool(bench_train.main, flag + ["--remat", "--skip_fwd"])
    want = per_run(0, out["train"]["calls"])
    launches["remat"] = lc
    model = init_weights(SphericalFusion(spec, device=dev), 0)
    sd0 = tame_heads(copy.deepcopy(model.state_dict()))
    tb = synthetic_batch(spec, TRAIN_BATCH, dev)
    runs = {}
    with deterministic_cudnn():
        for remat in (False, True):
            model.remat = remat
            runs[remat] = loss_and_grads(model, tb, sd0), copy.deepcopy(model.state_dict())
        model.remat = False
        nudge = loss_and_grads(model, nudged(tb, 5), sd0)
    del model
    torch.cuda.empty_cache()
    par = grad_parity(runs[True][0], runs[False][0])
    wit = grad_parity(runs[False][0], nudge)
    stats_equal = all(torch.equal(runs[True][1][k], v) for k, v in runs[False][1].items())
    peak = {"remat": out["train"]["max_memory_allocated_bytes"],
            "no_remat": results["f32"]["train"]["max_memory_allocated_bytes"]}
    emit({"phase": "remat", "gpu": gpu, "batch": TRAIN_BATCH, "precision": "f32 (tf32 off)",
          "step": {k: v for k, v in out["train"].items() if k != "flops_by_op"},
          "step_no_remat_device_ms": results["f32"]["train"]["device_ms"],
          "max_memory_allocated_bytes": peak, "parity": par, "nudge": wit,
          "running_stats_equal": stats_equal, "loss_tol": 1e-6, "ulp_ratio": ULP_RATIO,
          "launches": lc, "launches_expected": want})
    if not (par["loss_rel"] < 1e-6 and stats_equal and lc == want
            and par["grad_rel_max"] <= ULP_RATIO * wit["grad_rel_max"]
            and peak["remat"] < peak["no_remat"]):
        raise AssertionError("remat: see its line")
    del runs, nudge, tb

    # ---- bench_sweep ----
    out, lc = tool(bench_sweep.main, ["--device", DEVICE, "--batches", SWEEP_BATCHES,
                                      "--modes", SWEEP_MODES])
    launches["bench_sweep"] = lc
    want = per_run(out["forwards"])
    row = next(r for r in out["rows"]
               if r["batch"] == SWEEP_CHECK_BATCH and r["mode"] == "f16_merge")
    bench_ms = benches[SWEEP_CHECK_BATCH]["device_ms"]
    gap = abs(row["device_ms"] / bench_ms - 1)
    emit({"phase": "bench_sweep", "gpu": gpu, "rows": out["rows"], "launches": lc,
          "launches_expected": want, "f16_merge_vs_bench": {
              "batch": SWEEP_CHECK_BATCH, "sweep_device_ms": row["device_ms"],
              "bench_device_ms": bench_ms, "gap": gap, "tol": SWEEP_MS_TOL}})
    if lc != want or gap > SWEEP_MS_TOL:
        raise AssertionError("bench_sweep: see its line")

    # ---- sol_model: the card's rates, the floors, and each kernel row
    # against the time phase's bound for the same call ----
    time_rows = {(k, r["case"]): r for k, rs in rows.items() for r in rs
                 if r.get("recipe") in ("bf16", None)}
    sol, sol_launches, forwards = {}, {k: 0 for k in counts()}, 0
    for b in SOL_BATCHES:
        argv = ["--device", DEVICE, "--batch", str(b), "--train", "--erp_size",
                f"{ERP[0]},{ERP[1]}", "--patchsize", str(PATCH)]
        out, lc = tool(sol_model.main, argv + (["--calibrate"] if b == TRAIN_BATCH else []))
        sol[b] = out
        forwards += out["forwards"]
        sol_launches = {k: sol_launches[k] + lc[k] for k in lc}
        matched = []
        for r in out["rows"] + out["train_rows"]:
            key = sol_time_case(r["kernel"], r["stage"], b)
            if key in time_rows:
                ref = time_rows[key]["bound_ms"]
                matched.append({"stage": r["stage"], "case": key[1], "bound_ms": r["bound_ms"],
                                "time_row_bound_ms": ref})
                if abs(r["bound_ms"] / ref - 1) > FLOOR_TOL:
                    raise AssertionError(f"sol_model b{b} {r['stage']}: {r['bound_ms']} against "
                                         f"the time row's {ref}")
        emit({"phase": "sol_model", "gpu": gpu, "batch": b, "model": out["model"],
              "calibration": out["calibration"], "flops_t": out["flops_t"],
              "conv_floor_ms": out["conv_floor_ms"], "matmul_floor_ms": out["matmul_floor_ms"],
              "forward_floor_ms": out["forward_floor_ms"],
              "train_bound_ms": out["train_bound_ms"], "optimizer_ms": out["optimizer_ms"],
              "rows": out["rows"], "train_rows": out["train_rows"],
              "rows_matched_to_time_rows": matched,
              "measured_forward_device_ms": benches.get(b, {}).get("device_ms"),
              "measured_bf16_step_device_ms": bf16_step_ms if b == TRAIN_BATCH else None})
        if len(matched) < 2:
            raise AssertionError(f"sol_model b{b}: {len(matched)} rows matched a time row")
    cal = sol[TRAIN_BATCH]["calibration"]
    if not (cal["matmul_finite"] and cal["stream_gbs"] > 0 and cal["matmul_tflops"] > 0):
        raise AssertionError(f"sol_model calibration: {cal}")
    launches["sol_model"] = sol_launches
    if sol_launches != per_run(forwards):
        raise AssertionError(f"sol_model launches {sol_launches}, expected {per_run(forwards)}")

    # ---- eval_merge_dtype: the full protocol; the f16 merge's |delta
    # abs_rel| against the project's 1e-3 bar, reported, not gated ----
    t0 = time.perf_counter()
    out, lc = tool(eval_merge_dtype.main, ["--device", DEVICE, "--steps", str(EVAL_MERGE_STEPS)]
                   + EVAL_MERGE_ARGS)
    launches["eval_merge_dtype"] = lc
    n_evals = len(out["report"]) * (1 + len(eval_merge_dtype.CANDIDATES)) * 2  # 2 batches each
    want = per_run(n_evals, EVAL_MERGE_STEPS)
    emit({"phase": "eval_merge_dtype", "gpu": gpu, "steps": EVAL_MERGE_STEPS,
          "seconds": time.perf_counter() - t0, "report": out["report"], "launches": lc,
          "launches_expected": want})
    finite = all(np.isfinite(v) for r in out["report"].values() for m in ("f32_merge", "f16_merge")
                 for v in r[m].values())
    if lc != want or not finite:
        raise AssertionError("eval_merge_dtype: see its line")

    # ---- verify_kernels: every check PASS ----
    zero_counts()
    lines = run_tool(verify_kernels.main, [])
    lc = counts()
    launches["verify_kernels"] = lc
    out = json.loads(lines[-1])
    emit({"phase": "verify_kernels", "gpu": gpu, "lines": lines[:-1], "failures": out["failures"],
          "launches": lc})
    if out["failures"] or lines[-2] != "ALL PASS" or min(lc.values()) < 1:
        raise AssertionError("verify_kernels: see its line")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from omnifusion_torch import bench
    from omnifusion_torch.cli import infer, train, train_sem
    from omnifusion_torch.models import (
        SphericalFusion, SphericalFusionIterative, SphericalFusionSeg, init_weights,
    )
    from omnifusion_torch.ops import _build
    from omnifusion_torch.ops.probe import probe, probe_plain
    from omnifusion_torch.ops import quad_blend as qb
    from omnifusion_torch.ops.quad_blend import (
        CHUNK_ROWS, HEAVY_THRESHOLD, WIDE_LOAD, BlendTables, SpreadTables, heavy_pixels,
        overflow_load, quad_blend, quad_blend_plain, quad_spread, quad_spread_plain,
    )
    from omnifusion_torch.ops.upsample import up2x, up2x_adjoint, up2x_adjoint_plain, up2x_plain
    from omnifusion_torch.projection import (
        ProjectionSpec, build_pers2equi_grids, equi2pers, extract_views, insert_views, pers2equi,
    )
    from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
    from omnifusion_torch.projection.perspective import (
        inverse_perspective_tables, perspective_tables,
    )
    from omnifusion_torch.projection.spec import build_equi2pers_grids, build_vjp_tables
    from omnifusion_torch.tools import bench_components, bench_kernels, bench_merge, profile_forward
    from omnifusion_torch.training import create_train_state, train_step, train_step_sem
    from omnifusion_torch.utils.profiling import (
        blend_bound, blend_matrix, bound_ms as bound, gpu_line, nbytes, spread_bound, time_ms,
        time_ms_flushed, up2x_adjoint_bound, up2x_bound,
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
    tables_s = time.perf_counter() - t0
    tile_s = {}  # the host seconds of quad_blend's tile tables, built again
    for name, t in (("e2p", t_e2p), ("merge", t_p2e)):
        t0 = time.perf_counter()
        t.with_tiles(t.tiles.shape)
        tile_s[name] = time.perf_counter() - t0
    seg = t_p2e.vjp.over_ptr.diff()
    tail_len = t_p2e.tail_ptr.diff()
    emit({"phase": "tables", "seconds": tables_s, "tile_tables_seconds": tile_s,
          "e2p": {"n_out": t_e2p.n_out, "k": t_e2p.k, "n_in": t_e2p.n_in,
                  "k_t": t_e2p.vjp.k_t, "overflow": t_e2p.vjp.n_over,
                  "tile": list(t_e2p.tiles.shape), "tiles": t_e2p.tiles.n_tiles,
                  "max_footprint_pixels": t_e2p.tiles.pitch,
                  "footprint_per_output": t_e2p.tiles.footprint, "entries": t_e2p.tiles.entries},
          "merge": {"n_out": t_p2e.n_out, "k": t_p2e.k, "n_in": t_p2e.n_in,
                    "tail_entries": t_p2e.n_tail,
                    "tail_length_histogram": torch.bincount(tail_len).tolist(),
                    "tile": list(t_p2e.tiles.shape), "tiles": t_p2e.tiles.n_tiles,
                    "max_footprint_pixels": t_p2e.tiles.pitch,
                    "footprint_per_output": t_p2e.tiles.footprint, "entries": t_p2e.tiles.entries,
                    "k_t": t_p2e.vjp.k_t,
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
    # row counts that no chunk of staged rows divides, each dtype and layout
    # (channel-last: batches of 3 rows), staged and not at the most rows; the e2p's
    # store in the source dtype, bit for bit the cast of its f32 result; and
    # the same bits from three calls
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for rows in BLEND_ROWS:
            for case, shape, tables, cl in (("e2p", (rows, n_erp, 3), t_e2p, True),
                                            ("merge", (1, rows, t_p2e.n_in), t_p2e, False)):
                x = torch.rand(shape, device=dev, generator=g).to(dtype)
                want = quad_blend_plain(x, tables, channel_last=cl)
                note("quad_blend", check("quad_blend", f"{case}_{str(dtype)[6:]}_{rows}",
                                         quad_blend(x, tables, channel_last=cl), want, BLEND_TOL))
                if rows == BLEND_ROWS[-1]:  # the path the plan did not take
                    for staged in (True, False):
                        note("quad_blend", check(
                            "quad_blend", f"{case}_{str(dtype)[6:]}_{rows}_staged_{staged}",
                            qb._blend_kernel(x, tables, cl, staged=staged), want, BLEND_TOL))
    for dtype in (torch.float16, torch.bfloat16):
        x = x_e2p.to(dtype)
        calls = [quad_blend(x, t_e2p, channel_last=True, out_dtype=dtype) for _ in range(3)]
        cast = quad_blend(x, t_e2p, channel_last=True).to(dtype)
        torch.cuda.synchronize()
        same = torch.equal(calls[0], cast) and all(torch.equal(calls[0], c) for c in calls[1:])
        emit({"phase": "check", "kernel": "quad_blend", "case": f"e2p_{str(dtype)[6:]}_store",
              "calls": 3, "bitwise_equal_to_cast_and_run_to_run": same})
        if not same:
            raise AssertionError(f"quad_blend e2p {dtype} store: differs from the cast or a call")
    x = x_merge.half()
    calls = [quad_blend(x, t_p2e) for _ in range(3)]
    torch.cuda.synchronize()
    same = all(torch.equal(calls[0], c) for c in calls[1:])
    emit({"phase": "check", "kernel": "quad_blend", "case": "merge_f16_run_to_run", "calls": 3,
          "bitwise_equal": same})
    if not same:
        raise AssertionError("quad_blend merge: calls differ")
    del calls, cast, x, want

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
                                           up2x_adjoint(gy), up2x_adjoint_plain(gy), 0.0))
    # the bf16 recipe's decoder at batch 2: the first stage reads the f32
    # sum of layer4 and the tokens (its f32 check is above), the rest bf16
    for c, s in up_shapes[1:]:
        x = torch.rand(BATCH * p, c, s, s, device=dev, generator=g).bfloat16()
        check("up2x", "x".join(map(str, x.shape)) + "_bf16", up2x(x), up2x_plain(x), 1e-6,
              UP2X_BF16_RTOL)
    # the bf16 train step's backward: the adjoint of each bf16 decoder stage
    # on bf16 cotangents at batch 8 (the first stage's is f32, above); the
    # adjoint sums and rounds as its plain version does, so bit for bit
    for c, s in up_shapes[1:]:
        gy = torch.rand(TRAIN_BATCH * p, c, 2 * s, 2 * s, device=dev, generator=g).bfloat16()
        check("up2x_adjoint", "x".join(map(str, gy.shape)) + "_bf16", up2x_adjoint(gy),
              up2x_adjoint_plain(gy), 0.0)
    # odd sides and sides that are not powers of two (the stores are then
    # element by element), f32 and bf16
    for shape in ((5, 3, 7, 33), (2, 4, 1, 9)):
        x = torch.rand(shape, device=dev, generator=g)
        note("up2x", check("up2x", "x".join(map(str, shape)), up2x(x), up2x_plain(x), UP2X_TOL,
                           bitwise_equal=torch.equal(up2x(x), up2x_plain(x))))
        check("up2x", "x".join(map(str, shape)) + "_bf16", up2x(x.bfloat16()),
              up2x_plain(x.bfloat16()), 1e-6, UP2X_BF16_RTOL)
    # the adjoint on odd, ragged and 4k-wide sides (its blocks store element
    # by element where the width is not a multiple of 4), and on a view one
    # element into its storage (no 16-byte loads), f32 and bf16
    for shape in ((5, 3, 7, 33), (2, 4, 1, 9), (1, 3, 7, 5), (1, 2, 1, 4), (2, 3, 5, 12)):
        n_, c_, h_, w_ = shape
        gy = torch.rand(n_, c_, 2 * h_, 2 * w_, device=dev, generator=g)
        for gy_t in (gy, gy.bfloat16()):
            err = check("up2x_adjoint", "x".join(map(str, shape)) + f"_{str(gy_t.dtype)[6:]}",
                        up2x_adjoint(gy_t), up2x_adjoint_plain(gy_t), 0.0)
            if gy_t.dtype == torch.float32:
                note("up2x_adjoint", err)
    flat = torch.rand(1 + TRAIN_BATCH * p * 32 * 128 * 128, device=dev, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        gy = flat.to(dtype)[1:].view(TRAIN_BATCH * p, 32, 128, 128)
        check("up2x_adjoint", f"unaligned_view_{str(dtype)[6:]}", up2x_adjoint(gy),
              up2x_adjoint_plain(gy), 0.0, data_ptr_mod_16=gy.data_ptr() % 16)
    del flat, gy, gy_t
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
    # the bf16 step's last adjoint at that batch: 2.4e9 cotangents, past a
    # 32-bit index
    c, s = up_shapes[-1]
    gy = torch.rand(big * p, c, 2 * s, 2 * s, device=dev, generator=g, dtype=torch.bfloat16)
    if gy.numel() < 2**31:
        raise AssertionError(f"the adjoint's check does not reach 2^31 cotangents: {gy.shape}")
    check("up2x_adjoint", "x".join(map(str, gy.shape)) + "_bf16", up2x_adjoint(gy),
          lambda rows: up2x_adjoint_plain(gy[rows]), 0.0, chunk=512, cotangents=gy.numel())
    del gy
    torch.cuda.empty_cache()

    # ---- the iterative model's call patterns, and the merge at nrows 6,
    # fov 90, whose pixels hold up to 9 quads (one past the kernel's
    # register budget: the rest are read from global memory) ----
    spec_q = spec.with_patch_scale(4)
    spec_n6 = ProjectionSpec.create(ERP, PATCH, (N6_FOV, N6_FOV), N6_NROWS)
    t0 = time.perf_counter()
    t_q, t_n6 = equi2pers_tables(spec_q, dev), pers2equi_tables(spec_n6, dev)
    emit({"phase": "tables_iterative", "seconds": time.perf_counter() - t0,
          "e2p_q": {"patch": spec_q.patch_h, "n_out": t_q.n_out, "k": t_q.k,
                    "tile": list(t_q.tiles.shape), "entries": t_q.tiles.entries,
                    "footprint_per_output": t_q.tiles.footprint,
                    "staged": t_q.tiles.footprint <= qb.STAGE_MAX_FOOTPRINT,
                    "k_t": t_q.vjp.k_t, "overflow": t_q.vjp.n_over,
                    "heavy_pixels": t_q.vjp.heavy.numel()},
          "merge_n6": {"nrows": N6_NROWS, "fov": N6_FOV, "k": t_n6.k,
                       "tail_entries": t_n6.n_tail, "entries": t_n6.tiles.entries,
                       "register_budget": qb.MAX_ENTRIES,
                       "footprint_per_output": t_n6.tiles.footprint,
                       "staged": t_n6.tiles.footprint <= qb.STAGE_MAX_FOOTPRINT}})
    if t_n6.tiles.entries <= qb.MAX_ENTRIES:
        raise AssertionError(f"the nrows 6 merge holds {t_n6.tiles.entries} quads per pixel")
    x_n6 = torch.rand(BATCH, 2, t_n6.n_in, device=dev, generator=g)
    for dtype in (torch.float32, torch.float16):
        x = x_n6.to(dtype)
        want = quad_blend_plain(x, t_n6)
        note("quad_blend", check("quad_blend", f"merge_n6_{str(dtype)[6:]}", quad_blend(x, t_n6),
                                 want, BLEND_TOL, entries=t_n6.tiles.entries))
        for staged in (True, False):
            note("quad_blend", check("quad_blend", f"merge_n6_{str(dtype)[6:]}_staged_{staged}",
                                     qb._blend_kernel(x, t_n6, False, staged=staged), want,
                                     BLEND_TOL, entries=t_n6.tiles.entries))
    # the quarter-resolution equi2pers of a 1-channel f32 depth (the
    # feedback), at each batch; its tables weight no wrapped corner, so the
    # same call pattern (channel-last, 1 channel) goes through the wrapped
    # table too
    grids_q = build_equi2pers_grids(spec_q)
    for b in E2P_Q_BATCHES:
        depth = torch.rand(b, *ERP, 1, device=dev, generator=g) * 7 + 0.3
        note("quad_blend", check(
            "quad_blend", f"e2p_q_b{b}", equi2pers(depth, grids_q).reshape(b, -1, 1),
            quad_blend_plain(depth.reshape(b, -1, 1), t_q, channel_last=True), BLEND_TOL,
            BLEND_TOL))
    x = torch.rand(BATCH, n_erp, 1, device=dev, generator=g)
    note("quad_blend", check("quad_blend", "wrapped_corners_c1",
                             quad_blend(x, wrap, channel_last=True),
                             quad_blend_plain(x, wrap, channel_last=True), BLEND_TOL))
    # its backward: channel-last quad_spread, 1 channel, on its transposed tables
    atol, rtol = SPREAD_TOL[torch.float32]
    for b in (BATCH, TRAIN_BATCH):
        cot = torch.rand(b, t_q.n_out, 1, device=dev, generator=g)
        note("quad_spread", check("quad_spread", f"e2p_q_b{b}",
                                  quad_spread(cot, t_q.vjp, channel_last=True),
                                  quad_spread_plain(cot, t_q.vjp, channel_last=True), atol, rtol,
                                  overflow=t_q.vjp.n_over))
    del x, x_n6, want, depth, cot
    torch.cuda.empty_cache()

    # ---- the segmentation path's calls: the merge of SEG_CLASSES logits and
    # the confidence, SEG_CLASSES + 1 channel-first f32 rows per panorama, at
    # each timed batch, and its spread at the train batch; the perspective
    # views, forward and backward, 1 and 3 channels, f32 and bf16 (stored in
    # the source's dtype); the channel-last pers2equi ----
    seg_rows = SEG_CLASSES + 1
    for b in TIMED_BATCHES:
        x = torch.rand(b, seg_rows, t_p2e.n_in, device=dev, generator=g)
        note("quad_blend", check("quad_blend", f"merge_seg_b{b}", quad_blend(x, t_p2e),
                                 quad_blend_plain(x, t_p2e), BLEND_TOL, rows=b * seg_rows))
    cot_seg = torch.rand(TRAIN_BATCH, seg_rows, n_erp, device=dev, generator=g)
    atol, rtol = SPREAD_TOL[torch.float32]
    note("quad_spread", check("quad_spread", f"merge_seg_b{TRAIN_BATCH}",
                              quad_spread(cot_seg, t_p2e.vjp), quad_spread_plain(cot_seg, t_p2e.vjp),
                              atol, rtol, overflow=t_p2e.vjp.n_over))
    t0 = time.perf_counter()
    t_views = perspective_tables(VIEW_CENTERS, VIEW_FOV, VIEW_SIZE, ERP, dev)
    t_views_inv, view_mask = inverse_perspective_tables(VIEW_CENTERS, VIEW_FOV, VIEW_SIZE, ERP, dev)
    t_wide = perspective_tables(WIDE_VIEW_CENTERS, WIDE_VIEW_FOV, VIEW_SIZE, ERP, dev)
    t_wide_inv, _ = inverse_perspective_tables(WIDE_VIEW_CENTERS, WIDE_VIEW_FOV, VIEW_SIZE, ERP,
                                               dev)
    views_s = time.perf_counter() - t0
    emit({"phase": "tables_views", "seconds": views_s, **{
        name: {"views": len(c), "fov": list(f), "size": list(VIEW_SIZE), "n_out": t.n_out,
               "n_in": t.n_in, "tile": list(t.tiles.shape), "max_footprint_pixels": t.tiles.pitch,
               "footprint_per_output": t.tiles.footprint,
               "staged": t.tiles.footprint <= qb.STAGE_MAX_FOOTPRINT, "k_t": t.vjp.k_t,
               "overflow": t.vjp.n_over, "heavy_pixels": t.vjp.heavy.numel()}
        for name, c, f, t in (("extract", VIEW_CENTERS, VIEW_FOV, t_views),
                              ("insert", VIEW_CENTERS, VIEW_FOV, t_views_inv),
                              ("extract_wide", WIDE_VIEW_CENTERS, WIDE_VIEW_FOV, t_wide),
                              ("insert_wide", WIDE_VIEW_CENTERS, WIDE_VIEW_FOV, t_wide_inv))},
        "visible_share": view_mask.mean().item()})
    n_views = len(VIEW_CENTERS)
    for dtype in (torch.float32, torch.bfloat16):
        tol = (BLEND_TOL, 0.0) if dtype == torch.float32 else (BLEND_TOL, UP2X_BF16_RTOL)
        s_atol, s_rtol = SPREAD_TOL[dtype]
        for c in (1, 3):
            case = f"c{c}_{str(dtype)[6:]}"
            erp = torch.rand(BATCH, *ERP, c, device=dev, generator=g).to(dtype).requires_grad_()
            views = extract_views(erp, VIEW_CENTERS, VIEW_FOV, VIEW_SIZE)
            want = quad_blend_plain(erp.detach().reshape(BATCH, n_erp, c), t_views, True, dtype)
            err = check("quad_blend", f"extract_views_{case}", views.detach().reshape(want.shape),
                        want, *tol, views=n_views)
            equi, mask = insert_views(views, VIEW_CENTERS, VIEW_FOV, ERP)
            want = quad_blend_plain(views.detach().reshape(BATCH, -1, c), t_views_inv, True, dtype)
            err = max(err, check("quad_blend", f"insert_views_{case}",
                                 equi.detach().reshape(want.shape), want, *tol, views=n_views))
            if dtype == torch.float32:
                note("quad_blend", err)
            # backward through both: the spread of insert_views, then of
            # extract_views, each held to the plain spread of its cotangent
            cot = torch.rand(equi.shape, device=dev, generator=g).to(dtype)
            v_grad, = torch.autograd.grad(equi, views, cot, retain_graph=True)
            want = quad_spread_plain(cot.reshape(BATCH, -1, c), t_views_inv.vjp, True).to(dtype)
            err = check("quad_spread", f"insert_views_{case}", v_grad.reshape(want.shape), want,
                        s_atol, s_rtol, overflow=t_views_inv.vjp.n_over)
            equi.backward(cot)
            want = quad_spread_plain(v_grad.reshape(BATCH, -1, c), t_views.vjp, True).to(dtype)
            err = max(err, check("quad_spread", f"extract_views_{case}",
                                 erp.grad.reshape(want.shape), want, s_atol, s_rtol,
                                 overflow=t_views.vjp.n_over))
            if dtype == torch.float32:
                note("quad_spread", err)
    if view_mask.shape != (n_views, *ERP, 1) or not 0 < view_mask.mean().item() < 1:
        raise AssertionError(f"insert_views mask: {tuple(view_mask.shape)}")
    # the widest footprints: 120 degree views at the pole and the seam
    x = torch.rand(BATCH, n_erp, 3, device=dev, generator=g)
    note("quad_blend", check("quad_blend", "extract_views_wide",
                             quad_blend(x, t_wide, channel_last=True),
                             quad_blend_plain(x, t_wide, channel_last=True), BLEND_TOL,
                             max_footprint_pixels=t_wide.tiles.pitch))
    x = torch.rand(BATCH, t_wide_inv.n_in, 3, device=dev, generator=g)
    note("quad_blend", check("quad_blend", "insert_views_wide",
                             quad_blend(x, t_wide_inv, channel_last=True),
                             quad_blend_plain(x, t_wide_inv, channel_last=True), BLEND_TOL,
                             max_footprint_pixels=t_wide_inv.tiles.pitch))
    # the channel-last merge on the flagship's tables: 1 and 3 channels
    for c in (1, 3):
        pers = torch.rand(BATCH, spec.n_patches, PATCH, PATCH, c, device=dev, generator=g)
        note("quad_blend", check(
            "quad_blend", f"pers2equi_c{c}", pers2equi(pers, build_pers2equi_grids(spec)),
            quad_blend_plain(pers.reshape(BATCH, -1, c), t_p2e, True).reshape(BATCH, *ERP, c),
            BLEND_TOL, tail_entries=t_p2e.n_tail))
    # 16 f32 channels: the views' staged footprints do not fit a block's
    # shared memory twice, so the plan gathers from global memory
    for name, t_v in (("extract_views_c16", t_views), ("insert_views_c16", t_views_inv)):
        x = torch.rand(1, t_v.n_in, 16, device=dev, generator=g)
        staged = qb.blend_plan(t_v.tiles, 1, 16, 4)[0]
        note("quad_blend", check("quad_blend", name, quad_blend(x, t_v, channel_last=True),
                                 quad_blend_plain(x, t_v, channel_last=True), BLEND_TOL,
                                 staged=staged))
        if staged:
            raise AssertionError(f"{name}: the plan stages a footprint that cannot fit")
    # the views' tables (0.7 GB on the card with cot_seg) are built again
    # for the time rows: the earlier phases' peak memory stays comparable
    del x, erp, views, equi, mask, cot, v_grad, want, pers, cot_seg
    del t_views, t_views_inv, t_v, view_mask, t_wide, t_wide_inv
    perspective_tables.cache_clear()
    inverse_perspective_tables.cache_clear()
    torch.cuda.empty_cache()

    # ---- the fused heads at the flagship's patch, and at the batched
    # serving cells' batch ----
    heads = heads_phase(gpu, timer)

    # ---- up2x's NHWC form at the batched serving cells' shapes, and the
    # forwards that launch it ----
    channels_last = channels_last_phase(gpu, timer)

    # ---- the folded trunk: every model's forward without autograd against
    # its unfolded forward, and the b64 forward timed both ways ----
    fold_phase(gpu, timer)

    # ---- the README's patch 256: its kernels at the b64 shapes, its
    # serving forward's launches and time, cli/infer.py ----
    p256_phase(gpu, timer)

    # ---- the extras: pano_stretch on the blend and spread kernels, and the
    # DIBR chain against float64 ----
    extras = extras_phase(gpu, timer)
    for name, err in extras["errs"].items():
        note(name, err)

    # ---- the uniform patch layout: its tables, the kernels on them, the
    # three models through their Python API (uniform_layout), time rows ----
    uniform = uniform_phase(gpu, timer)
    for name, err in uniform["errs"].items():
        note(name, err)

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
    f64_witness = {"oneshot": f64}  # ddp_gloo2's witnesses
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

    # ---- serve_iterative: the iterative model (2 passes) through the entry
    # point, f32 and the bf16 recipe, from the same panoramas. The seeded
    # weights with their heads tamed (tame_heads) go in as a checkpoint:
    # untamed, the first pass's depth reaches 1e3-6e4 and the second's
    # overflows the recipe's f16 merge ----
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        inputs = os.path.join(tmp, "panos")
        os.makedirs(inputs)
        for i, f in enumerate(frames):
            np.save(os.path.join(inputs, f"pano{i}.npy"), f)
        argv_it = ["--input", inputs, "--seed", "0", "--device", DEVICE, "--batch", str(BATCH),
                   "--erp_size", f"{ERP[0]},{ERP[1]}", "--patchsize", str(PATCH),
                   "--fov", str(FOV), "--nrows", str(NROWS), "--model", "iterative",
                   "--iter", str(ITERS)]
        ckpt = os.path.join(tmp, "iterative_tamed.pt")
        sd_it = tame_heads(infer.build_model(infer.build_parser().parse_args(argv_it))
                           .state_dict())
        torch.save(sd_it, ckpt)
        argv_it += ["--checkpoint", ckpt]
        args_it = infer.build_parser().parse_args(argv_it + ["--save_path",
                                                             os.path.join(tmp, "out")])
        zero_counts()
        t0 = time.perf_counter()
        written_it = infer.run_infer(args_it)
        serve_it_s = time.perf_counter() - t0
        serve_it_launches = counts()
        depths_it = [np.load(w) for w in written_it]
        args_it_bf16 = infer.build_parser().parse_args(argv_it + [
            "--bf16", "--merge_dtype", "f16", "--save_path", os.path.join(tmp, "out_bf16")])
        zero_counts()
        t0 = time.perf_counter()
        written_it_bf16 = infer.run_infer(args_it_bf16)
        serve_it_bf16_s = time.perf_counter() - t0
        serve_it_bf16_launches = counts()
        depths_it_bf16 = [np.load(w) for w in written_it_bf16]
        # the served weights, for the parity below
        model_it, model_it_bf16 = infer.build_model(args_it), infer.build_model(args_it_bf16)
    per_forward_it = per_run(n_forwards, passes=ITERS)
    for d in depths_it + depths_it_bf16:
        if d.shape != ERP or not np.isfinite(d).all() or (d < 0).any():
            raise AssertionError(f"bad depth: shape {d.shape}, finite {np.isfinite(d).all()}")
    # f32: the same forward with the plain versions on the card, each pass
    # and the served last pass, at serve's bounds
    batch_it = torch.from_numpy(np.stack(frames[:BATCH])).to(dev)
    with torch.inference_mode():
        kern = [p[..., 0].cpu().numpy() for p in model_it(batch_it)]
        with plain_versions():
            plain = [p[..., 0].cpu().numpy() for p in model_it(batch_it)]
    pass_stats = [rel_stats(k, p) for k, p in zip(kern, plain)]
    served_stats = rel_stats(np.stack(depths_it[:BATCH]), plain[-1])
    # the CUDA path against the CPU path at the small size, full depth,
    # heads tamed (untamed, the depth there is 0 almost everywhere)
    outs = []
    for device in (dev, torch.device("cpu")):
        m = SphericalFusionIterative(small, num_iters=ITERS, device=device)
        m.load_state_dict(tame_heads(init_weights(m, 0).state_dict()))
        m.eval()
        with torch.inference_mode():
            outs.append([p[..., 0].cpu().numpy() for p in m(x_small.to(device))])
    small_stats = [rel_stats(c, h) for c, h in zip(*outs)]
    # the recipe: each pass's distance from the f32 forward, kernels against
    # plain versions, at the flagship and at the witness configuration (card
    # against CPU), as serve_bf16 holds the one-shot's. Pass 2 reads pass
    # 1's bf16 depth: three quarters of its pixels lie more than 0.02 from
    # f32 and its share above 0.05 sits on a steep slope, which the rounding
    # of pass 1 moves either way (one card, the same weights, the input and
    # the input moved by one bf16 ulp at a random half of its values under
    # three seeds: kernels 1.56, 1.12, 0.82, 1.28%, plain versions 1.00,
    # 0.97, 1.02, 1.17%). So the statistics pool the batch and
    # BF16_NUDGES such moved copies of it
    inputs = [batch_it] + [bf16_nudged(batch_it, seed) for seed in BF16_NUDGES]
    def passes(model, x):  # per pass, the depth of every input, pooled
        with torch.inference_mode():
            out = [model(xi) for xi in x]
        return [np.concatenate([o[i][..., 0].cpu().numpy() for o in out]) for i in range(ITERS)]

    f32, kern16 = passes(model_it, inputs), passes(model_it_bf16, inputs)
    with plain_versions():
        plain16 = passes(model_it_bf16, inputs)
    del model_it, model_it_bf16
    k_stats = [rel_stats(k, f) for k, f in zip(kern16, f32)]
    p_stats = [rel_stats(p, f) for p, f in zip(plain16, f32)]
    w_out = {}
    for device in (dev, torch.device("cpu")):
        for dt, mdt in ((None, None), (torch.bfloat16, torch.float16)):
            m = SphericalFusionIterative(wspec, num_iters=ITERS, depth=WITNESS_DEPTH,
                                         encoder_stages=WITNESS_STAGES, dtype=dt, merge_dtype=mdt,
                                         device=device)
            m.load_state_dict(tame_heads(init_weights(m, 0).state_dict()))
            with torch.inference_mode():
                w_out[device.type, dt] = [p[..., 0].cpu().numpy()
                                          for p in m.eval()(x_w.to(device))]
    w_card, w_cpu = ([rel_stats(a, b) for a, b in zip(w_out[d, torch.bfloat16], w_out[d, None])]
                     for d in (dev.type, "cpu"))
    del m, w_out
    torch.cuda.empty_cache()
    emit({"phase": "serve_iterative", "passes": ITERS, "panoramas": len(written_it),
          "batch": BATCH, "forwards": n_forwards, "seconds_with_model_build": serve_it_s,
          "launches": serve_it_launches, "launches_expected": per_forward_it,
          "heads": "tamed",
          "parity_vs_plain_on_card": {"precision": "f32 (tf32 off)", "passes": pass_stats,
                                      "served": served_stats},
          "parity_cuda_vs_cpu_small": {"erp": list(SMALL_ERP), "patch": SMALL_PATCH,
                                       "passes": small_stats},
          "bf16": {"recipe": "bf16 trunk + f16 merge", "panoramas": len(written_it_bf16),
                   "seconds_with_model_build": serve_it_bf16_s,
                   "launches": serve_it_bf16_launches,
                   "pooled_inputs": len(inputs),
                   "kernels_vs_f32": k_stats, "plain_vs_f32": p_stats,
                   "kernels_vs_plain": [rel_stats(k, p) for k, p in zip(kern16, plain16)],
                   "ratio_bound": BF16_RATIO,
                   "witness_config": {"card_vs_f32": w_card, "cpu_vs_f32": w_cpu,
                                      "ratio_bound": BF16_RATIO_CPU, "share_slack": BF16_SHARE},
                   "served_vs_served_f32": rel_stats(np.stack(depths_it_bf16),
                                                     np.stack(depths_it))}})
    for launches in (serve_it_launches, serve_it_bf16_launches):
        if launches != per_forward_it:
            raise AssertionError(f"iterative serve launches {launches}, expected "
                                 f"{ITERS * 2} blend and {ITERS * 5} up2x per forward")
    for i, (ps, ss) in enumerate(zip(pass_stats, small_stats)):
        assert_parity(ps, f"iterative pass {i + 1} vs plain forward")
        assert_parity(ss, f"iterative pass {i + 1}, cuda vs cpu at the small size")
    assert_parity(served_stats, "served iterative depth vs plain forward")
    for i in range(ITERS):
        for key in ("median_rel", "q999_rel", "frac_rel_gt_0.05"):
            slack = BF16_SHARE if key == "frac_rel_gt_0.05" else 0.0
            if not k_stats[i][key] <= BF16_RATIO * p_stats[i][key] + slack:
                raise AssertionError(f"iterative bf16 pass {i + 1} {key}: kernels {k_stats[i]}, "
                                     f"plain {p_stats[i]}")
            if not w_card[i][key] <= BF16_RATIO_CPU * w_cpu[i][key] + slack:
                raise AssertionError(f"iterative bf16 pass {i + 1} at the witness configuration "
                                     f"{key}: card {w_card[i]}, cpu {w_cpu[i]}")

    # ---- train_iterative: steps, a validation pass and checkpoints through
    # the entry point, then one step held against the plain versions ----
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        argv = ["--dataset", "synthetic", "--synthetic_size", str(n_train), "--epochs", "1",
                "--batch", str(TRAIN_BATCH), "--erp_size", f"{ERP[0]},{ERP[1]}",
                "--patchsize", str(PATCH), "--fov", str(FOV), "--nrows", str(NROWS),
                "--seed", "0", "--device", DEVICE, "--workers", "4", "--model", "iterative",
                "--iter", str(ITERS), "--save_path", os.path.join(tmp, "run")]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        history_it = train.run_training(train.build_parser().parse_args(argv))
        train_it_s = time.perf_counter() - t0
        train_it_launches = counts()
        train_it_peak = torch.cuda.max_memory_allocated()
        ckpts = sorted(os.listdir(os.path.join(tmp, "run", "ckpt")))
    want_it = per_run(val_forwards, TRAIN_STEPS, ITERS)
    emit({"phase": "train_iterative", "passes": ITERS, "batch": TRAIN_BATCH,
          "steps": history_it["steps"], "validation_forwards": val_forwards,
          "train_loss": history_it["train_loss"], "val": history_it["val"],
          "checkpoints": ckpts, "seconds_with_model_build": train_it_s,
          "max_memory_allocated_bytes": train_it_peak, "launches": train_it_launches,
          "launches_expected": want_it})
    if history_it["steps"] != TRAIN_STEPS or not np.isfinite(history_it["train_loss"]).all():
        raise AssertionError(f"iterative train run: {history_it}")
    if train_it_launches != want_it:
        raise AssertionError(f"iterative train launches {train_it_launches}, expected {want_it}")
    if ckpts != ["best.pt", "latest.pt"]:
        raise AssertionError(f"checkpoints: {ckpts}")
    # one step (the CLI's default merge, without the confidence), kernels
    # against plain versions, with the float64 and one-ulp witnesses
    model = init_weights(SphericalFusionIterative(spec, num_iters=ITERS, device=dev), 0)
    sd0 = tame_heads(copy.deepcopy(model.state_dict()))
    torch.cuda.reset_peak_memory_stats()
    with deterministic_cudnn():
        kern = loss_and_grads(model, tb, sd0, confidence=False)
        sd1 = copy.deepcopy(model.state_dict())
        kern_rs = loss_and_grads(model, tb, sd1, train=False, confidence=False)
        with plain_versions():
            plain = [loss_and_grads(model, b, sd0, confidence=False) for b in (tb, tb_nudged)]
            plain_rs = [loss_and_grads(model, b, sd1, train=False, confidence=False)
                        for b in (tb, tb_nudged)]
            f64 = loss_and_grads(*as_f64(model, tb, sd0), confidence=False)
            f64_rs = loss_and_grads(*as_f64(model, tb, sd1), train=False, confidence=False)
    del model
    torch.cuda.empty_cache()
    par, ok = step_parity(kern, plain[0], f64, plain[1])
    par_rs, ok_rs = step_parity(kern_rs, plain_rs[0], f64_rs, plain_rs[1])
    emit({"phase": "train_iterative_parity_vs_plain_on_card", "batch": TRAIN_BATCH,
          "heads": "tamed", "confidence": False, "precision": "f32 (tf32 off), cuDNN deterministic",
          "loss_tol": LOSS_TOL, "f64_ratio": F64_RATIO, "ulp_ratio": ULP_RATIO,
          "median_tol_running_stats": GRAD_TOL, "train_mode": par, "running_stats": par_rs,
          "max_memory_allocated_bytes_with_float64": torch.cuda.max_memory_allocated()})
    if not (ok and ok_rs and par_rs["grad_rel_median"] < GRAD_TOL):
        raise AssertionError(f"iterative train step vs plain versions: {par}, {par_rs}")
    f64_witness["iterative"] = f64
    del kern, kern_rs, plain, plain_rs, f64, f64_rs

    # ---- eval: omnifusion_torch.cli.test.run_eval, both models, from an
    # upstream-layout checkpoint of the seeded weights (heads tamed), held
    # against the same run on the plain versions; then the same eval at the
    # small size, card against CPU. No PNG dumps (--visualize_interval 0):
    # these phases import no cv2, PIL or matplotlib. eval_rate: the flagship
    # eval's panoramas/s, EVAL_RATE_RUNS runs of EVAL_RATE_PANOS each ----
    import importlib.util

    from omnifusion_torch.data import SyntheticDataset

    eval_forwards = -(-EVAL_PANOS // BATCH)
    eval_launches = {}
    ds = SyntheticDataset(2, *ERP, seed=0)
    ds[0]
    t0 = time.perf_counter()
    ds[1]
    sample_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        for name, flags, passes in (("oneshot", [], 1),
                                    ("iterative", ["--model", "iterative", "--iter", str(ITERS)],
                                     ITERS)):
            base = ["--dataset", "synthetic", "--batch", str(BATCH), "--visualize_interval", "0",
                    "--fov", str(FOV), "--nrows", str(NROWS)] + flags
            cls = SphericalFusionIterative if passes > 1 else SphericalFusion
            res, argv = {}, {}
            for size, erp, patch, scale in (("flagship", ERP, PATCH, HEAD_SCALE),
                                            ("small", SMALL_ERP, SMALL_PATCH,
                                             SMALL_EVAL_HEAD_SCALE)):
                m = init_weights(cls(ProjectionSpec.create(erp, patch, (FOV, FOV), NROWS),
                                     device=dev), 0)
                ckpt = os.path.join(tmp, f"{name}_{size}.pth")
                upstream_checkpoint(tame_heads(m.state_dict(), scale), ckpt)
                del m
                argv[size] = base + ["--checkpoint", ckpt, "--erp_size", f"{erp[0]},{erp[1]}",
                                     "--patchsize", str(patch),
                                     "--save_path", os.path.join(tmp, name)]
                a = argv[size] + ["--synthetic_size", str(EVAL_PANOS)]
                res[size] = eval_run(a + ["--device", DEVICE])
                if size == "flagship":
                    with plain_versions():
                        res["plain"] = eval_run(a + ["--device", DEVICE])
                else:
                    res["cpu"] = eval_run(a + ["--device", "cpu"])
            eval_launches[name] = res["flagship"][2]
            want_l = per_run(eval_forwards, passes=passes)
            gaps = metric_gaps(res["flagship"][0], res["plain"][0])
            depth_stats = rel_stats(res["flagship"][3], res["plain"][3])
            emit({"phase": "eval", "model": name, "passes": passes, "panoramas": EVAL_PANOS,
                  "batch": BATCH, "checkpoint": "upstream layout (Conv3d kernels, module., "
                  "state_dict), seeded weights, heads tamed", "head_scale": HEAD_SCALE,
                  "cv2_importable": importlib.util.find_spec("cv2") is not None,
                  "metrics": res["flagship"][0], "metrics_plain": res["plain"][0],
                  "metric_gaps": gaps, "tol": EVAL_TOL, "last_batch_vs_plain": depth_stats,
                  "launches": res["flagship"][2], "launches_expected": want_l, "gpu": gpu})
            if res["flagship"][2] != want_l:
                raise AssertionError(f"eval {name}: launches {res['flagship'][2]}, "
                                     f"expected {want_l}")
            if max(gaps.values()) > EVAL_TOL:
                raise AssertionError(f"eval {name} vs plain versions: {gaps}")
            assert_parity(depth_stats, f"eval {name}: last batch vs plain versions")
            small_gaps = metric_gaps(res["small"][0], res["cpu"][0])
            emit({"phase": "eval_cuda_vs_cpu_small", "model": name, "erp": list(SMALL_ERP),
                  "patch": SMALL_PATCH, "head_scale": SMALL_EVAL_HEAD_SCALE,
                  "metrics": res["small"][0], "metrics_cpu": res["cpu"][0],
                  "metric_gaps": small_gaps, "tol": EVAL_TOL,
                  "last_batch": rel_stats(res["small"][3], res["cpu"][3])})
            if max(small_gaps.values()) > EVAL_TOL:
                raise AssertionError(f"eval {name}, cuda vs cpu at the small size: {small_gaps}")
            for r in res.values():
                if not all(np.isfinite(v) for v in r[0].values()):
                    raise AssertionError(f"eval {name}: {r[0]}")
            rate_forwards = -(-EVAL_RATE_PANOS // BATCH)
            rates = []
            for _ in range(EVAL_RATE_RUNS):
                avg, rate, launches, _ = eval_run(
                    argv["flagship"] + ["--synthetic_size", str(EVAL_RATE_PANOS),
                                        "--device", DEVICE])
                if launches != per_run(rate_forwards, passes=passes):
                    raise AssertionError(f"eval_rate {name}: launches {launches}")
                if not all(np.isfinite(v) for v in avg.values()):
                    raise AssertionError(f"eval_rate {name}: {avg}")
                rates.append(rate)
            med = float(np.median(rates))
            emit({"phase": "eval_rate", "model": name, "passes": passes,
                  "panoramas": EVAL_RATE_PANOS, "batch": BATCH, "runs": EVAL_RATE_RUNS,
                  "panos_per_s": rates, "panos_per_s_median": med,
                  "spread_rel": (max(rates) - min(rates)) / med,
                  "panos_per_s_of": f"cli.test.run_eval, f32 (TF32 off), {rate_forwards - 1} batches "
                                    "after the first (metric syncs and the 2-thread loader "
                                    "making synthetic panoramas included)",
                  "host_ms_per_synthetic_panorama": sample_ms, "gpu": gpu})
    torch.cuda.empty_cache()

    # ---- train_bf16: the bf16 trunk (f32 parameters) with the f16 merge
    # through the entry point, 3 steps, a validation pass and checkpoints;
    # one step held against the plain versions; the step timed ----
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        argv = ["--dataset", "synthetic", "--synthetic_size", str(n_train), "--epochs", "1",
                "--batch", str(TRAIN_BATCH), "--erp_size", f"{ERP[0]},{ERP[1]}",
                "--patchsize", str(PATCH), "--fov", str(FOV), "--nrows", str(NROWS),
                "--seed", "0", "--device", DEVICE, "--workers", "4", "--bf16",
                "--merge_dtype", "f16", "--save_path", os.path.join(tmp, "run")]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        history_bf16 = train.run_training(train.build_parser().parse_args(argv))
        train_bf16_s = time.perf_counter() - t0
        train_bf16_launches = counts()
        train_bf16_peak = torch.cuda.max_memory_allocated()
        ckpts = sorted(os.listdir(os.path.join(tmp, "run", "ckpt")))
    want = per_run(val_forwards, TRAIN_STEPS)
    if history_bf16["steps"] != TRAIN_STEPS or not np.isfinite(history_bf16["train_loss"]).all():
        raise AssertionError(f"bf16 train run: {history_bf16}")
    if train_bf16_launches != want:
        raise AssertionError(f"bf16 train launches {train_bf16_launches}, expected {want}")
    if ckpts != ["best.pt", "latest.pt"]:
        raise AssertionError(f"checkpoints: {ckpts}")
    # one step, kernels against plain versions; witnesses: the same weights
    # in float64 without the bf16 casts (the function the recipe rounds),
    # and the plain versions on the input moved by one bf16 ulp
    model = init_weights(SphericalFusion(spec, dtype=torch.bfloat16, merge_dtype=torch.float16,
                                         device=dev), 0)
    sd0 = tame_heads(copy.deepcopy(model.state_dict()))
    tb16_nudged = dict(tb, rgb=bf16_nudged(tb["rgb"], 5))
    with deterministic_cudnn():
        kern = loss_and_grads(model, tb, sd0)
        with plain_versions():
            plain = [loss_and_grads(model, b, sd0) for b in (tb, tb16_nudged)]
            f64 = loss_and_grads(*as_f64(SphericalFusion(spec, device=dev), tb, sd0))
    del model
    torch.cuda.empty_cache()
    par, ok = step_parity(kern, plain[0], f64, plain[1], loss_tol=BF16_LOSS_TOL)
    del kern, plain, f64
    # the step's time, peak memory and the kernels' device time in it
    state = create_train_state(init_weights(SphericalFusion(
        spec, dtype=torch.bfloat16, merge_dtype=torch.float16, device=dev), 0))
    torch.cuda.reset_peak_memory_stats()
    ms = timer(lambda: train_step(state, tb), iters=5, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        train_step(state, tb)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    step_peak = torch.cuda.max_memory_allocated()
    bf16_step_ms = ms
    bf16_split = kernel_split_ms(lambda: train_step(state, tb), (
        "quad_blend_kernel", "up2x_kernel", "quad_spread_kernel", "quad_spread_heavy_kernel",
        "up2x_adjoint_kernel"), iters=5)
    del state
    torch.cuda.empty_cache()
    emit({"phase": "train_bf16", "recipe": "bf16 trunk on f32 parameters + f16 merge",
          "batch": TRAIN_BATCH, "steps": history_bf16["steps"],
          "train_loss": history_bf16["train_loss"], "val": history_bf16["val"],
          "checkpoints": ckpts, "seconds_with_model_build": train_bf16_s,
          "max_memory_allocated_bytes": train_bf16_peak, "launches": train_bf16_launches,
          "launches_expected": want, "heads": "tamed", "loss_tol": BF16_LOSS_TOL,
          "f64_ratio": F64_RATIO, "ulp_ratio": ULP_RATIO, "nudge": "one bf16 ulp",
          "parity_vs_plain_on_card": par, "gpu": gpu,
          "step": {"device_ms": ms, "wall_ms": wall_ms,
                   "panos_per_s": TRAIN_BATCH / (wall_ms / 1e3),
                   "max_memory_allocated_bytes": step_peak},
          "kernel_ms_per_step": bf16_split, "kernel_ms_from": "torch.profiler, 5 steps"})
    if not ok:
        raise AssertionError(f"bf16 train step vs plain versions: {par}")

    # ---- serve_seg: the segmentation model (SEG_CLASSES classes, full
    # ResNet-34 and transformer, seeded weights, heads tamed) on the served
    # panoramas, f32, TF32 off, held against the same forward with the plain
    # versions on the card ----
    model = init_weights(SphericalFusionSeg(spec, num_classes=SEG_CLASSES, device=dev), 0)
    model.load_state_dict(tame_heads(model.state_dict()))
    model.eval()
    x = torch.from_numpy(np.stack(frames[:BATCH])).to(dev)
    zero_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = model(x)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        serve_seg_launches = counts()
        with plain_versions():
            ref = model(x)
    if logits.shape != (BATCH, *ERP, SEG_CLASSES) or logits.dtype != torch.float32:
        raise AssertionError(f"segmentation logits {tuple(logits.shape)} {logits.dtype}")
    if not torch.isfinite(logits).all():
        raise AssertionError("segmentation logits are not finite")
    stats = rel_stats(logits.cpu().numpy(), ref.cpu().numpy())
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    classes = torch.bincount(logits.argmax(-1).flatten(), minlength=SEG_CLASSES)
    emit({"phase": "serve_seg", "classes": SEG_CLASSES, "batch": BATCH, "heads": "tamed",
          "precision": "f32 (tf32 off)", "seconds_first_forward": seg_s,
          "launches": serve_seg_launches, "launches_expected": per_run(1),
          "logits_vs_plain": stats, "argmax_agreement": agree,
          "argmax_agreement_note": "random-weight logits have near-ties: a number, not a bound",
          "predicted_class_share": (classes.float() / classes.sum()).tolist()})
    if serve_seg_launches != per_run(1):
        raise AssertionError(f"serve_seg launches {serve_seg_launches}, expected {per_run(1)}")
    assert_parity(stats, "segmentation logits vs plain forward")
    del model, logits, ref, x
    torch.cuda.empty_cache()

    # ---- train_sem: one epoch of cli.train_sem --dataset synthetic at the
    # flagship (its fixed set of SEM_TRAIN_SET panoramas: 4 steps at batch
    # 8), a validation by mIoU over SEM_VAL_SET panoramas, checkpoints ----
    sem_steps = SEM_TRAIN_SET // TRAIN_BATCH
    sem_val_forwards = -(-SEM_VAL_SET // TRAIN_BATCH)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as tmp:
        argv = ["--dataset", "synthetic", "--epochs", "1", "--batch", str(TRAIN_BATCH),
                "--erp_size", f"{ERP[0]},{ERP[1]}", "--patchsize", str(PATCH),
                "--fov", str(FOV), "--nrows", str(NROWS), "--num_classes", str(SEG_CLASSES),
                "--seed", "0", "--device", DEVICE, "--workers", "4",
                "--save_path", os.path.join(tmp, "run")]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        history_sem = train_sem.main(argv)
        train_sem_s = time.perf_counter() - t0
        train_sem_launches = counts()
        train_sem_peak = torch.cuda.max_memory_allocated()
        ckpts = sorted(os.listdir(os.path.join(tmp, "run", "ckpt")))
        steps_saved = torch.load(os.path.join(tmp, "run", "ckpt", "latest.pt"),
                                 map_location="cpu", weights_only=True)["step"]
    want_sem = per_run(sem_val_forwards, sem_steps)
    miou = history_sem["miou"][-1]
    emit({"phase": "train_sem", "classes": SEG_CLASSES, "batch": TRAIN_BATCH,
          "steps": steps_saved, "validation_forwards": sem_val_forwards,
          "train_loss": history_sem["train_loss"], "miou": history_sem["miou"],
          "best_miou": history_sem["best_miou"], "checkpoints": ckpts,
          "seconds_with_model_build": train_sem_s, "max_memory_allocated_bytes": train_sem_peak,
          "launches": train_sem_launches, "launches_expected": want_sem, "gpu": gpu})
    if steps_saved != sem_steps or not np.isfinite(history_sem["train_loss"]).all():
        raise AssertionError(f"train_sem run: {history_sem}, {steps_saved} steps")
    if not (np.isfinite(miou) and 0.0 <= miou <= 1.0):
        raise AssertionError(f"train_sem mIoU {miou}")
    if train_sem_launches != want_sem:
        raise AssertionError(f"train_sem launches {train_sem_launches}, expected {want_sem}")
    # best is written when the mIoU rises above its start, 0 (cli/train_sem.py)
    if ckpts != (["best.pt", "latest.pt"] if miou > 0 else ["latest.pt"]):
        raise AssertionError(f"train_sem checkpoints {ckpts} at mIoU {miou}")

    # ---- train_sem_parity_vs_plain_on_card: one step's loss and gradients
    # at batch SEM_PARITY_BATCH, kernels against plain versions, with the
    # float64 and one-ulp witnesses (step_parity), in train mode and on the
    # running statistics the step left ----
    sb = semantic_batch(spec, SEM_PARITY_BATCH, dev)
    sb_nudged = nudged(sb, 5)
    model = init_weights(SphericalFusionSeg(spec, num_classes=SEG_CLASSES, device=dev), 0)
    sd0 = tame_heads(copy.deepcopy(model.state_dict()))
    torch.cuda.reset_peak_memory_stats()
    with deterministic_cudnn():
        kern = loss_and_grads(model, sb, sd0)
        sd1 = copy.deepcopy(model.state_dict())
        kern_rs = loss_and_grads(model, sb, sd1, train=False)
        with plain_versions():
            plain = [loss_and_grads(model, b, sd0) for b in (sb, sb_nudged)]
            plain_rs = [loss_and_grads(model, b, sd1, train=False) for b in (sb, sb_nudged)]
            f64 = loss_and_grads(*as_f64(model, sb, sd0))
            f64_rs = loss_and_grads(*as_f64(model, sb, sd1), train=False)
    del model
    torch.cuda.empty_cache()
    par, ok = step_parity(kern, plain[0], f64, plain[1])
    par_rs, ok_rs = step_parity(kern_rs, plain_rs[0], f64_rs, plain_rs[1])
    emit({"phase": "train_sem_parity_vs_plain_on_card", "batch": SEM_PARITY_BATCH,
          "classes": SEG_CLASSES, "heads": "tamed",
          "precision": "f32 (tf32 off), cuDNN deterministic", "loss_tol": LOSS_TOL,
          "f64_ratio": F64_RATIO, "ulp_ratio": ULP_RATIO, "median_tol_running_stats": GRAD_TOL,
          "train_mode": par, "running_stats": par_rs,
          "max_memory_allocated_bytes_with_float64": torch.cuda.max_memory_allocated()})
    if not (ok and ok_rs and par_rs["grad_rel_median"] < GRAD_TOL):
        raise AssertionError(f"segmentation train step vs plain versions: {par}, {par_rs}")
    f64_witness["seg"] = f64
    del kern, kern_rs, plain, plain_rs, f64, f64_rs

    # ---- kernel timings: the f32 path's calls (on_path), and the bf16
    # recipe's (recipe "bf16": e2p in bf16, the merge in f16, the decoder's
    # upsamples in bf16 but the first) ----
    # (the e2p's bf16 calls store bf16, as equi2pers does); then bench.py's
    # batches 64 and 256, and the sweep ----
    rows = {k: [] for k in errs}
    blend_cases = [("e2p", x_e2p, t_e2p, True, None), ("merge_f32", x_merge, t_p2e, False, None),
                   ("e2p_bf16", x_e2p.bfloat16(), t_e2p, True, "bf16"),
                   ("merge_f16", x_merge.half(), t_p2e, False, "bf16")]
    for b in BENCH_BATCHES:
        blend_cases += [
            (f"e2p_bf16_b{b}", lambda b=b: torch.rand(b, n_erp, 3, device=dev, generator=g)
             .bfloat16(), t_e2p, True, "bf16"),
            (f"merge_f16_b{b}", lambda b=b: torch.rand(b, 2, t_p2e.n_in, device=dev, generator=g)
             .half(), t_p2e, False, "bf16"),
        ]
    # the iterative model's calls off the one-shot path (recipe names the
    # path): the quarter-resolution equi2pers of an f32 depth, and the merge
    # at nrows 6, fov 90
    blend_cases += [(f"e2p_q_b{b}", lambda b=b: torch.rand(b, n_erp, 1, device=dev, generator=g)
                     * 7 + 0.3, t_q, True, "iterative") for b in E2P_Q_BATCHES]
    blend_cases += [
        ("merge_n6_f32", lambda: torch.rand(BATCH, 2, t_n6.n_in, device=dev, generator=g), t_n6,
         False, "nrows6"),
        (f"merge_n6_f16_b{MERGE_BATCH}", lambda: torch.rand(
            MERGE_BATCH, 2, t_n6.n_in, device=dev, generator=g).half(), t_n6, False, "nrows6"),
    ]
    # the segmentation merge (recipe names the path) at each timed batch,
    # the perspective views: 8 views of 256x256 from the ERP (extract) and
    # back (insert), and the channel-last merge, batch 2, 3 channels, f32
    t_views = perspective_tables(VIEW_CENTERS, VIEW_FOV, VIEW_SIZE, ERP, dev)
    t_views_inv, _ = inverse_perspective_tables(VIEW_CENTERS, VIEW_FOV, VIEW_SIZE, ERP, dev)
    cot_seg = torch.rand(TRAIN_BATCH, seg_rows, n_erp, device=dev, generator=g)
    blend_cases += [(f"merge_seg_b{b}", lambda b=b: torch.rand(
        b, seg_rows, t_p2e.n_in, device=dev, generator=g), t_p2e, False, "segmentation")
        for b in TIMED_BATCHES]
    blend_cases += [
        ("extract_views", lambda: torch.rand(BATCH, n_erp, 3, device=dev, generator=g), t_views,
         True, "views"),
        ("insert_views", lambda: torch.rand(BATCH, t_views_inv.n_in, 3, device=dev, generator=g),
         t_views_inv, True, "views"),
        # the channel-last merge on the flagship's tables, 3 channels
        ("pers2equi_c3", lambda: torch.rand(BATCH, t_p2e.n_in, 3, device=dev, generator=g),
         t_p2e, True, "channel_last"),
    ]
    sweep = []
    for name, x, tables, cl, recipe in blend_cases:
        x = x() if callable(x) else x
        out_dtype = x.dtype if cl else None  # equi2pers stores the ERP's dtype
        out = quad_blend(x, tables, channel_last=cl, out_dtype=out_dtype)
        b_ms, b_by = blend_bound(x, tables, out)
        w_csr = blend_matrix(tables, x.dtype)
        dense = (x.permute(1, 0, 2) if cl else x.permute(2, 0, 1)).reshape(tables.n_in, -1).contiguous()
        lib_out = torch.sparse.mm(w_csr, dense)
        want_out = out.permute(1, 0, 2) if cl else out.permute(2, 0, 1)
        lib_err = (lib_out.float() - want_out.reshape(tables.n_out, -1).float()).abs().max().item()
        del out, lib_out, want_out
        rows["quad_blend"].append({
            "case": name, "shape": list(x.shape), "batch": x.shape[0], "on_path": recipe is None,
            "recipe": recipe, "out_dtype": str(out_dtype or torch.float32),
            "ms": timer(lambda: quad_blend(x, tables, channel_last=cl, out_dtype=out_dtype)),
            "plain_ms": timer(lambda: quad_blend_plain(x, tables, channel_last=cl, out_dtype=out_dtype),
                              iters=10 if x.shape[0] == BATCH else 3, warmup=1),
            "library_ms": timer(lambda: torch.sparse.mm(w_csr, dense)),
            "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
        })
        del w_csr, dense
        # the sweep, at the recipe's dtypes and each batch, and at the
        # nrows 6 merge's widest call
        if recipe == "bf16" or name == f"merge_n6_f16_b{MERGE_BATCH}":
            cpu = 3 if cl else 1
            units = x.shape[0] if cl else x.shape[0] * x.shape[1]
            plan = qb.blend_plan(tables.tiles, units, cpu, x.element_size())
            rows["quad_blend"][-1].update(tile=list(tables.tiles.shape), staged=plan[0],
                                          chunk_units=plan[1], unit_block=plan[2])
            for shape in TILE_SWEEP:
                t_sw = tables.with_tiles(shape)
                for staged, r, ub in ([(True, r, None) for r in CHUNK_SWEEP]
                                      + [(False, CHUNK_ROWS, ub) for ub in UNIT_SWEEP]):
                    ub = units if ub is None else max(1, ub // cpu)
                    sweep.append({"case": name, "tile": list(shape), "staged": staged,
                                  "R": r if staged else None, "unit_block": None if staged else ub,
                                  "ms": timer(lambda: qb._blend_kernel(
                                      x, t_sw, cl, out_dtype, staged, r, None if staged else ub))})
            del t_sw
        torch.cuda.empty_cache()
    emit({"phase": "sweep", "kernel": "quad_blend", "gpu": gpu,
          "kept": "each time row's tile, staged, chunk_units and unit_block", "rows": sweep})
    cot_q = torch.rand(TRAIN_BATCH, t_q.n_out, 1, device=dev, generator=g)
    for name, cot, t, cl, on_path in (("merge_f32_b8", cot_merge, t_p2e.vjp, False, True),
                                      ("e2p_b8", cot_e2p, t_e2p.vjp, True, False),
                                      (f"e2p_q_b{TRAIN_BATCH}", cot_q, t_q.vjp, True, False),
                                      (f"merge_seg_b{TRAIN_BATCH}", cot_seg, t_p2e.vjp, False,
                                       False)):
        out = quad_spread(cot, t, channel_last=cl)
        b_ms, b_by = spread_bound(cot, t, out)
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
    for b, recipe in ((BATCH, None), (BATCH, "bf16"), (TRAIN_BATCH, None), (TRAIN_BATCH, "bf16")):
        for i, (c, s) in enumerate(up_shapes):
            shape = (b * p, c, s, s)
            x = torch.rand(shape, device=dev, generator=g)
            if recipe == "bf16" and i > 0:
                x = x.bfloat16()
            if b == BATCH:
                b_ms, b_by = up2x_bound(x)
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
                # the bf16 train step's cotangents are bf16 but the first
                # stage's (recipe "bf16")
                gy = torch.rand(b * p, c, 2 * s, 2 * s, device=dev, generator=g).to(x.dtype)
                b_ms, b_by = up2x_adjoint_bound(x)
                size = [b * p, c, s, s]
                rows["up2x_adjoint"].append({
                    "case": "x".join(map(str, shape)) + ("_bf16" if x.dtype != torch.float32 else ""),
                    "shape": list(gy.shape), "on_path": recipe is None, "recipe": recipe,
                    "ms": timer(lambda: up2x_adjoint(gy)),
                    "ms_l2_flushed": time_ms_flushed(lambda: up2x_adjoint(gy), dev, 20, 3),
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

    # ---- end to end, the iterative model (2 passes): the forward in f32,
    # TF32 and the bf16 recipe, and the train step, with its peak memory ----
    it_times = {}
    for label, tf32, a in (("f32", False, args_it), ("tf32", True, args_it),
                           ("bf16", False, args_it_bf16)):
        # the served weights (their checkpoint went with its directory)
        model = infer.build_model(argparse.Namespace(**{**vars(a), "checkpoint": None}))
        model.load_state_dict(sd_it)
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
            it_times[f"{label}_b{b}"] = {"device_ms": ms, "wall_ms": wall_ms,
                                         "panos_per_s": b / (wall_ms / 1e3)}
        del model
    pin_f32()
    emit({"phase": "forward_iterative", "gpu": gpu, "passes": ITERS, "erp": list(ERP),
          "patch": PATCH, "bf16": "bf16 trunk + f16 merge", **it_times})
    step_it_times = {}
    state = create_train_state(init_weights(SphericalFusionIterative(spec, device=dev), 0))
    for label, tf32 in (("f32", False), ("tf32", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.reset_peak_memory_stats()
        ms = timer(lambda: train_step(state, tb, False), iters=5, warmup=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            train_step(state, tb, False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5
        step_it_times[label] = {"device_ms": ms, "wall_ms": wall_ms,
                                "panos_per_s": TRAIN_BATCH / (wall_ms / 1e3),
                                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    pin_f32()
    emit({"phase": "train_step_iterative", "gpu": gpu, "passes": ITERS, "batch": TRAIN_BATCH,
          "erp": list(ERP), "patch": PATCH, "confidence": False, **step_it_times})
    del state
    torch.cuda.empty_cache()

    # ---- end to end, the segmentation model: the forward and the train
    # step (cross-entropy on cli.train_sem's synthetic labels), f32, TF32
    # off, at each timed batch, with their peak memory ----
    model = init_weights(SphericalFusionSeg(spec, num_classes=SEG_CLASSES, device=dev), 0)
    seg_fwd, seg_step = {}, {}
    for b in TIMED_BATCHES:
        x = torch.rand(b, *ERP, 3, device=dev, generator=g)
        model.eval()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms = timer(lambda: model(x), iters=5, warmup=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 5
        seg_fwd[f"f32_b{b}"] = {"device_ms": ms, "wall_ms": wall_ms,
                                "panos_per_s": b / (wall_ms / 1e3),
                                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    state = create_train_state(model)
    for b in TIMED_BATCHES:
        sb = semantic_batch(spec, b, dev)
        torch.cuda.reset_peak_memory_stats()
        ms = timer(lambda: train_step_sem(state, sb), iters=5, warmup=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            train_step_sem(state, sb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 5
        seg_step[f"f32_b{b}"] = {"device_ms": ms, "wall_ms": wall_ms,
                                 "panos_per_s": b / (wall_ms / 1e3),
                                 "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit({"phase": "forward_seg", "gpu": gpu, "classes": SEG_CLASSES, "erp": list(ERP),
          "patch": PATCH, "precision": "f32 (tf32 off)", **seg_fwd})
    emit({"phase": "train_step_seg", "gpu": gpu, "classes": SEG_CLASSES, "erp": list(ERP),
          "patch": PATCH, "precision": "f32 (tf32 off)", **seg_step})
    del state, model, x, sb
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
    if not (launches["quad_blend"] > 0 and launches["quad_spread"] > 0 and launches["up2x"] > 0
            and launches["up2x_adjoint"] > 0 and launches["probe"] == 0):
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

    multi_launches = multi_device_phases(gpu, f64_witness)
    tool_launches = measurement_tool_phases(gpu, rows, benches, step_times["f32"]["device_ms"],
                                            bf16_step_ms)

    # launches: the training run's count (its steps and validation
    # forwards), and per forward or step; the times: per forward at batch 2
    # (forward kernels) or per train step at batch 8 (backward kernels),
    # summed over the kernel's calls in it
    # the kernels of each device-time row of the bf16 train step
    split_names = {"quad_blend": ("quad_blend_kernel",), "up2x": ("up2x_kernel",),
                   "quad_spread": ("quad_spread_kernel", "quad_spread_heavy_kernel"),
                   "up2x_adjoint": ("up2x_adjoint_kernel",)}
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
        recipe = [r for r in rows[name] if r.get("recipe") == "bf16" and r.get("batch", BATCH) == BATCH]
        # the iterative model's calls per forward at batch 2 or step at
        # batch 8: (time row, calls)
        case = {r["case"]: r for r in rows[name]}
        if name == "quad_blend":
            it_rows = [(case["e2p"], 1), (case["merge_f32"], ITERS),
                       (case[f"e2p_q_b{BATCH}"], ITERS - 1)]
        elif name == "quad_spread":
            it_rows = [(rs[0], ITERS), (case[f"e2p_q_b{TRAIN_BATCH}"], ITERS - 1)]
        else:
            it_rows = [(r, ITERS) for r in rs]
        iterative = {f"{k}_iterative": sum(r[k] * n for r, n in it_rows)
                     for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        # the segmentation model's calls per forward at batch 2 or step at
        # batch 8: the one-shot model's, with the 14-row merge and its spread
        if name == "quad_blend":
            seg_rows_t = [(case["e2p"], 1), (case[f"merge_seg_b{BATCH}"], 1)]
        elif name == "quad_spread":
            seg_rows_t = [(case[f"merge_seg_b{TRAIN_BATCH}"], 1)]
        else:
            seg_rows_t = [(r, 1) for r in rs]
        segmentation = {f"{k}_segmentation": sum(r[k] * n for r, n in seg_rows_t)
                        for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        # the uniform layouts' calls per forward at batch 2 (equi2pers and
        # the merge) or per step at batch 8 (the merge's spread)
        uni = {}
        for layout in UNIFORM_LAYOUTS:
            tag = layout.split(":")[1]
            u_rows = [r for r in uniform["rows"].get(name, [])
                      if r["layout"] == layout and not r["case"].startswith("e2p_q")]
            uni.update({f"{k}_uniform_{tag}": sum(r[k] for r in u_rows)
                        for k in ("ms", "plain_ms", "bound_ms", "library_ms")} if u_rows else {})
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
            **({"ms_l2_flushed": sum(r["ms_l2_flushed"] for r in rs),
                "ms_l2_flushed_bf16_recipe": sum(r["ms_l2_flushed"] for r in recipe)}
               if all("ms_l2_flushed" in r for r in rows[name]) else {}),
            "launches_iterative": train_it_launches[name],
            "launches_iterative_of": f"iterative training run ({ITERS} passes): {TRAIN_STEPS} "
                                     f"steps at batch {TRAIN_BATCH}, {val_forwards} validation "
                                     f"forwards",
            f"launches_per_iterative_{per}": train_it_launches[name] / n_per,
            "launches_serve_iterative": serve_it_launches[name],
            **iterative,
            "launches_eval": eval_launches["oneshot"][name],
            "launches_eval_iterative": eval_launches["iterative"][name],
            "launches_eval_of": f"cli.test.run_eval of {EVAL_PANOS} panoramas at batch {BATCH}",
            "launches_train_bf16": train_bf16_launches[name],
            "launches_train_bf16_of": f"--bf16 --merge_dtype f16 training run: {TRAIN_STEPS} "
                                      f"steps at batch {TRAIN_BATCH}, {val_forwards} validation "
                                      f"forwards",
            "ms_train_bf16_step": sum(bf16_split[k] for k in split_names[name]),
            "launches_serve_seg": serve_seg_launches[name],
            "launches_train_sem": train_sem_launches[name],
            "launches_train_sem_of": f"cli.train_sem run: {sem_steps} steps at batch "
                                     f"{TRAIN_BATCH}, {sem_val_forwards} validation forward",
            f"launches_per_train_sem_{per}": train_sem_launches[name] / (
                sem_steps + sem_val_forwards if per == "forward" else sem_steps),
            **segmentation,
            "launches_ddp_gloo2_per_rank": multi_launches["ddp_gloo2_per_rank"][name],
            "launches_ddp_gloo2_of": "one one-shot DDP train step per rank, 2 gloo ranks on "
                                     f"the card, batch {TRAIN_BATCH // DDP_RANKS} per rank",
            **{f"launches_{k}": v[name] for k, v in multi_launches.items()
               if k.startswith("mesh_model_")},
            "launches_mesh_model_of": "one one-shot DDP train step per rank, gloo ranks on "
                                      "the card on the mesh data x model (1x2, 2x2), the "
                                      "trunk on the rank's rows, e2p and merge whole",
            "launches_mesh1": multi_launches["mesh1"][name],
            "launches_mesh1_of": f"cli.train --mesh 1: {TRAIN_STEPS} steps at batch "
                                 f"{TRAIN_BATCH}, {val_forwards} validation forwards",
            "launches_uniform_layout": uniform["launches"]["total"][name],
            "launches_uniform_layout_of": f"uniform_layout: at {UNIFORM}, one-shot forwards "
                                          f"(f32, bf16 recipe), the iterative model ({ITERS} "
                                          f"passes) and segmentation at batch {BATCH}, two f32 "
                                          f"train steps at batch {TRAIN_BATCH} (train mode, "
                                          f"running statistics); at {UNIFORM_STRESS}, a one-shot "
                                          f"forward at batch {BATCH}",
            **uni,
            **{f"launches_{k}": v[name] for k, v in tool_launches.items()},
            **({"launches_pano_stretch": extras["launches"][name],
                "launches_pano_stretch_of": "pano_stretch forward and backward at "
                                            f"{len(STRETCH_KS)} (kx, ky), f32 and bf16, batch "
                                            f"{BATCH}",
                **{f"{k}_pano_stretch": extras["rows"][name][k]
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
               if name in extras["rows"] else {}),
            "launches_tools_of": "each tool's run in this process (bench_train: f32, tf32, "
                                 "bf16 and iterative_f32, the forwards and steps its JSON "
                                 "line counts; remat: bench_train --remat --skip_fwd; "
                                 f"bench_sweep --batches {SWEEP_BATCHES} --modes {SWEEP_MODES}; "
                                 f"sol_model at batches {list(SOL_BATCHES)}; eval_merge_dtype "
                                 f"--steps {EVAL_MERGE_STEPS}; verify_kernels)",
        })
    kernels.append({
        "name": "probe", "route": "cuda", "source": "omnifusion_torch/csrc/probe.cu",
        "replaces": "tools/bench_pallas_merge.py:57", "launches": merge_launches["probe"],
        "launches_of": f"merge shootout (omnifusion_torch/tools/bench_merge.py) at batch {MERGE_BATCH}",
        **{k: probe_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "ms_per": "call on (256, 128) f32", "library": "torch.mul(x, 2)",
        "launches_verify_kernels": tool_launches["verify_kernels"]["probe"],
    })
    head_row = next(r for r in heads["rows"] if r["on_path"])
    kernels.append({
        "name": "fused_heads", "route": "cuda", "source": "omnifusion_torch/csrc/heads.cu",
        "replaces": "no Pallas kernel (XLA's convolution, omnifusion_tpu/models/"
                    "spherical_fusion.py:174-175)",
        "launches": train_launches["fused_heads"],
        "launches_of": f"training run: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} (none), "
                       f"{val_forwards} validation forwards",
        "launches_serve": serve_launches["fused_heads"],
        "launches_serve_iterative": serve_it_launches["fused_heads"],
        "launches_serve_seg": serve_seg_launches["fused_heads"],
        "bound_ratio": heads["bound_ratio"],
        **{k: head_row[k] for k in ("case", "ms", "library_ms", "bound_ms", "bound_by")},
        "ms_per": f"call on the batch-{HEADS_BATCH} bf16 channels-last map, 2 outputs",
        "library": "the plain version on the same map: F.conv2d (cuDNN) and the activations",
        "rows": heads["rows"],
    })
    kernels.append({
        "name": "up2x NHWC form", "route": "cuda",
        "source": "omnifusion_torch/csrc/up2x.cu (up2x_kernel_nhwc)",
        "replaces": "no Pallas kernel: up2x's layout where autograd records nothing",
        "launches_serve": channels_last["served"], "rows": channels_last["rows"],
    })
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
