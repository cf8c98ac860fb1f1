#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from omnifusion_torch/csrc/ (one nvcc call),
holds each kernel against its plain PyTorch version at the shapes the
one-shot forward gives it, serves a few panoramas at the flagship config
(512x1024 ERP, patch 128, fov 80, nrows 4, f32, seeded random weights)
through omnifusion_torch.cli.infer.run_infer, checks the depth against the
same forward with the plain versions on the card and against the CPU at a
small size, and times each kernel beside its bound, its plain version and
one library call that computes the same function.

Prints one JSON object per phase, then the card's name and power limit as
nvidia-smi gives them, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no last
line; so does a machine without a CUDA device, or a directory without the
repository beside this file.

Precision: f32 convolutions and matmuls are pinned to full f32
(cudnn.allow_tf32 = False, matmul precision "highest") for every phase
except the one forward timing labelled tf32.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BLEND_TOL = 2e-6  # inputs in [0, 1), weights summing to <= 1: f32 rounding of a 4*K-term sum
UP2X_TOL = 1e-6  # inputs in [0, 1): f32 rounding of a 4-tap stencil


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def pin_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def plain_versions():
    """Route the main path's kernel wrappers to their plain versions, on the
    card. Only this script does this, to compare the whole forward."""
    import omnifusion_torch.models.layers as layers
    import omnifusion_torch.projection.ops as proj_ops
    from omnifusion_torch.ops.quad_blend import quad_blend_plain
    from omnifusion_torch.ops.upsample import up2x_plain

    saved = proj_ops.quad_blend, layers.up2x
    proj_ops.quad_blend, layers.up2x = quad_blend_plain, up2x_plain
    try:
        yield
    finally:
        proj_ops.quad_blend, layers.up2x = saved


class Timer:
    """Device time of a callable with CUDA events. Launches queue behind a
    device-side sleep long enough to cover their enqueue, so the events time
    the kernels back to back and not the host's launch rate."""

    def __init__(self):
        probe = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        probe[0].record()
        torch.cuda._sleep(10_000_000)
        probe[1].record()
        probe[1].synchronize()
        self.cycles_per_ms = 10_000_000 / probe[0].elapsed_time(probe[1])

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2.0 * host_ms * iters + 2.0) * self.cycles_per_ms))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def blend_matrix(tables):
    """The blend's sparse map as a CSR (N_out, N_in) matrix, for the library
    yardstick torch.sparse.mm."""
    n_in, w = tables.n_in, tables.row_stride
    rows = [torch.arange(tables.n_out, device=tables.idx.device).repeat_interleave(tables.k)]
    cols = [tables.idx.long().reshape(-1)]
    vals = [tables.w4.reshape(-1, 4)]
    if tables.n_tail:
        rows.append(tables.tail_pix.long())
        cols.append(tables.tail_idx.long())
        vals.append(tables.tail_w)
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    ri = torch.cat([r] * 4)
    ci = torch.cat([(c + off) % n_in for off in (0, 1, w, w + 1)])
    vi = torch.cat([v[:, q] for q in range(4)])
    keep = vi != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([ri[keep], ci[keep]]), vi[keep], (tables.n_out, n_in)
    ).coalesce()
    return coo.to_sparse_csr()


def check_blend(name, x, tables, channel_last, quad_blend, quad_blend_plain):
    got = quad_blend(x, tables, channel_last=channel_last)
    want = quad_blend_plain(x, tables, channel_last=channel_last)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    line = {"phase": "check", "kernel": "quad_blend", "case": name, "shape": list(x.shape),
            "dtype": str(x.dtype), "tail_entries": tables.n_tail, "max_abs_err": err,
            "tol": BLEND_TOL}
    emit(line)
    if not err <= BLEND_TOL:
        raise AssertionError(f"quad_blend {name}: max abs err {err} > {BLEND_TOL}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from omnifusion_torch.cli import infer
    from omnifusion_torch.models import SphericalFusion, init_weights
    from omnifusion_torch.ops import _build
    from omnifusion_torch.ops.quad_blend import BlendTables, quad_blend, quad_blend_plain
    from omnifusion_torch.ops.upsample import up2x, up2x_plain
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables

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

    spec = ProjectionSpec.create(ERP, PATCH, (FOV, FOV), NROWS)
    t0 = time.perf_counter()
    t_e2p, t_p2e = equi2pers_tables(spec, dev), pers2equi_tables(spec, dev)
    emit({"phase": "tables", "seconds": time.perf_counter() - t0,
          "e2p": {"n_out": t_e2p.n_out, "k": t_e2p.k, "n_in": t_e2p.n_in},
          "merge": {"n_out": t_p2e.n_out, "k": t_p2e.k, "n_in": t_p2e.n_in,
                    "tail_entries": t_p2e.n_tail}})

    # ---- kernel 1 against its plain version, at the forward's shapes ----
    g = torch.Generator(device=dev).manual_seed(0)
    n_erp = ERP[0] * ERP[1]
    x_e2p = torch.rand(BATCH, n_erp, 3, device=dev, generator=g)
    x_merge = torch.rand(BATCH, 2, t_p2e.n_in, device=dev, generator=g)
    blend_err = max(
        check_blend("e2p", x_e2p, t_e2p, True, quad_blend, quad_blend_plain),
        check_blend("merge_f32", x_merge, t_p2e, False, quad_blend, quad_blend_plain),
        check_blend("merge_f16", x_merge.half(), t_p2e, False, quad_blend, quad_blend_plain),
        check_blend("merge_bf16", x_merge.bfloat16(), t_p2e, False, quad_blend, quad_blend_plain),
    )
    # corners past the end of the source, with weight: they must wrap modulo
    # N_in, as the JAX roll does (a direct read there is an illegal address)
    rng = np.random.default_rng(0)
    n_out = 8192
    wrap = BlendTables.create(
        rng.integers(n_erp - 2 * ERP[1], n_erp, size=(n_out, 2)).astype(np.int32),
        rng.random((n_out, 2, 4)).astype(np.float32) / 8,
        ERP[1], n_erp, dev,
        tail_ptr=np.arange(n_out + 1, dtype=np.int32),
        tail_pix=np.arange(n_out, dtype=np.int32),
        tail_idx=np.full(n_out, n_erp - 1, np.int32),
        tail_w=rng.random((n_out, 4)).astype(np.float32) / 8,
    )
    x_wrap = torch.rand(BATCH, 3, n_erp, device=dev, generator=g)
    blend_err = max(blend_err, check_blend("wrapped_corners", x_wrap, wrap, False,
                                           quad_blend, quad_blend_plain))

    # ---- kernel 2 against its plain version ----
    p = spec.n_patches
    up_shapes = [(BATCH * p, c, s, s) for c, s in ((512, 4), (128, 8), (64, 16), (64, 32), (32, 64))]
    up_err = 0.0
    for shape in up_shapes + [(BATCH, 3, 1, 1)]:
        x = torch.rand(shape, device=dev, generator=g)
        err = (up2x(x) - up2x_plain(x)).abs().max().item()
        emit({"phase": "check", "kernel": "up2x", "shape": list(shape), "max_abs_err": err,
              "tol": UP2X_TOL})
        if not err <= UP2X_TOL:
            raise AssertionError(f"up2x {shape}: max abs err {err} > {UP2X_TOL}")
        up_err = max(up_err, err)

    # ---- the slice: serve panoramas through the entry point ----
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
        quad_blend.launches = 0
        up2x.launches = 0
        t0 = time.perf_counter()
        written = infer.run_infer(args)
        serve_s = time.perf_counter() - t0
        launches = {"quad_blend": quad_blend.launches, "up2x": up2x.launches}
        depths = [np.load(w) for w in written]
    n_forwards = -(-N_PANOS // BATCH)
    emit({"phase": "serve", "panoramas": len(written), "batch": BATCH, "forwards": n_forwards,
          "seconds_with_model_build": serve_s, "launches": launches})
    if launches != {"quad_blend": 2 * n_forwards, "up2x": 5 * n_forwards}:
        raise AssertionError(f"expected 2 blend and 5 up2x launches per forward: {launches}")
    for d in depths:
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

    # ---- timings ----
    timer = Timer()
    rows = {"quad_blend": [], "up2x": []}
    for name, x, tables, cl in (("e2p", x_e2p, t_e2p, True), ("merge_f32", x_merge, t_p2e, False)):
        out = quad_blend(x, tables, channel_last=cl)
        n_quads = int((tables.w4.sum(-1) > 0).sum().item()) + tables.n_tail
        b_ms, b_by = bound(
            nbytes(x, out, tables.idx, tables.w4, tables.tail_ptr, tables.tail_idx, tables.tail_w),
            8.0 * n_quads * x.numel() / tables.n_in,
        )
        w_csr = blend_matrix(tables)
        dense = (x.permute(1, 0, 2) if cl else x.permute(2, 0, 1)).reshape(tables.n_in, -1).contiguous()
        lib_out = torch.sparse.mm(w_csr, dense)
        want = out.permute(1, 0, 2) if cl else out.permute(2, 0, 1)
        lib_err = (lib_out - want.reshape(tables.n_out, -1)).abs().max().item()
        rows["quad_blend"].append({
            "case": name, "shape": list(x.shape),
            "ms": timer(lambda: quad_blend(x, tables, channel_last=cl)),
            "plain_ms": timer(lambda: quad_blend_plain(x, tables, channel_last=cl), iters=10),
            "library_ms": timer(lambda: torch.sparse.mm(w_csr, dense)),
            "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
        })
    for shape in up_shapes:
        x = torch.rand(shape, device=dev, generator=g)
        b_ms, b_by = bound(5 * nbytes(x), 9.0 * 4 * x.numel())
        rows["up2x"].append({
            "case": "x".join(map(str, shape)), "shape": list(shape),
            "ms": timer(lambda: up2x(x)),
            "plain_ms": timer(lambda: up2x_plain(x), iters=10),
            "library_ms": timer(lambda: torch.nn.functional.interpolate(
                x, scale_factor=2, mode="bilinear", align_corners=False)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    for kernel, rs in rows.items():
        for r in rs:
            emit({"phase": "time", "kernel": kernel, "gpu": gpu, **r})

    fwd = {}
    for label, tf32 in (("f32", False), ("tf32", True)):
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
            fwd[f"{label}_b{b}"] = {"device_ms": ms, "wall_ms": wall_ms,
                                    "panos_per_s": b / (wall_ms / 1e3)}
    pin_f32()
    emit({"phase": "forward", "gpu": gpu, "erp": list(ERP), "patch": PATCH, "fov": FOV,
          "nrows": NROWS, **fwd})

    kernels = []
    for name, source, replaces, err in (
        ("quad_blend", "omnifusion_torch/csrc/quad_blend.cu",
         "omnifusion_tpu/ops/pallas_blend.py:81", blend_err),
        ("up2x", "omnifusion_torch/csrc/up2x.cu",
         "omnifusion_tpu/ops/pallas_resize.py:46", up_err),
    ):
        rs = rows[name]
        bys = {r["bound_by"] for r in rs}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if bys == {"bytes"} else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
            "per": "one forward at batch 2: the sum over its calls",
        })
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
