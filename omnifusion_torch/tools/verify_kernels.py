"""One command that holds each hand kernel against its plain version on the
card; prints a PASS or FAIL line each, then one JSON line, and exits 1 on
any failure.

    python -m omnifusion_torch.tools.verify_kernels
    python -m omnifusion_torch.tools.verify_kernels --skip_model   # the kernels alone
    python -m omnifusion_torch.tools.verify_kernels --only_model   # the composed step alone

The port's counterpart of ``tools/verify_kernels.py``, at its small spec
(128x256 ERP, patch 32, fov 80, nrows 4), on CUDA tensors:

- ``quad_blend`` at equi2pers (f32 and the recipe's bf16 source) and at the
  merge (f32, and the f16 and bf16 sources);
- ``quad_spread`` at the merge's backward and at equi2pers's;
- ``up2x`` (f32, bf16) and ``up2x_adjoint`` (f32, bf16; bit for bit) at the
  decoder's five stages;
- the probe (bit for bit);
- the fused heads (f32 and bf16, 2 and 14 outputs) at the decoder's last
  stage, within rounding's bound of the plain version (``heads_gap``);
- the composed check: one train step of a small model (depth 2, one block
  per stage, tamed heads) on the kernels against the same step on the plain
  versions: the loss, the gradient norm and every gradient tensor, with a
  float64 run and a one-ulp nudge of the input as witnesses
  (``step_parity``).

The tolerances are chip_smoke.py's, which imports them from here. The tool
needs the card: without one it exits 1 with a message. The JAX tool's
``--cpu`` (Pallas's interpret mode) has no counterpart: the port's plain
versions are held against the JAX package by the CPU test suite.

This module also holds what chip_smoke.py's parity phases share with it:
``plain_versions``, ``heads_gap``, ``heads_params``, ``tame_heads``,
``nudged``, ``as_f64``, ``loss_and_grads``, ``grad_parity`` and
``step_parity``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys

import numpy as np
import torch

BLEND_TOL = 2e-6  # inputs in [0, 1), weights summing to <= 1: f32 rounding of a 4*K-term sum
UP2X_TOL = 1e-6  # inputs in [0, 1): f32 rounding of a 4-tap stencil (the adjoint: bitwise)
# a bf16 result: the kernel and the plain version both compute in f32 and
# round once to bf16, so they differ by at most one bf16 ulp (2^-7 relative)
UP2X_BF16_RTOL = 2.0**-7
# inputs in [0, 1): f32 sums of up to 2194 products per pixel (the merge's
# longest overflow load), summed in another order by the plain version, whose
# index_add_ order changes from run to run: rtol 2194 * 2^-24 = 1.3e-4;
# 16-bit results: one rounding more
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
HEAD_SCALE = 0.05  # tame_heads
# the folded trunk (models/layers.py: conv_bn_relu) against the same model
# unfolded, each output's relative L2 gap: f32 (TF32 off) within
# FOLD_F32_GAP (the BatchNorm's affine map in another order, 47 times a
# pass); bf16 no farther from the f32 forward than FOLD_BF16_RATIO times the
# unfolded bf16 forward's gap (the same weights, convolution outputs and bf16
# roundings, the BatchNorm's f32 map in another order; a wrong fold moves it
# by the whole output)
FOLD_F32_GAP, FOLD_BF16_RATIO = 1e-4, 1.25

# the JAX tool's spec, and its batches: 64 panoramas for each kernel and
# for the composed step
ERP, PATCH = (128, 256), 32
BLEND_BATCH, TRAIN_BATCH = 64, 64
ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="each hand kernel against its plain version")
    ap.add_argument("--skip_model", action="store_true", help="the kernels alone")
    ap.add_argument("--only_model", action="store_true", help="the composed train step alone")
    return ap


@contextlib.contextmanager
def plain_versions():
    """Route every kernel launch of the main paths, forward and backward, to
    the kernel's plain version, on the card; the autograd Functions stay, so
    autograd still never differentiates the plain code. Only the parity
    checks do this, to compare the whole forward and train step."""
    import omnifusion_torch.ops.epilogue as ep
    import omnifusion_torch.ops.heads as hd
    import omnifusion_torch.ops.quad_blend as qb
    import omnifusion_torch.ops.upsample as ups

    saved = (qb._blend_kernel, qb._spread_kernel, ups._up2x_kernel, ups._adjoint_kernel,
             hd._heads_kernel, ep._epilogue_kernel)
    qb._blend_kernel, qb._spread_kernel = qb.quad_blend_plain, qb.quad_spread_plain
    ups._up2x_kernel, ups._adjoint_kernel = ups.up2x_plain, ups.up2x_adjoint_plain
    hd._heads_kernel = hd.fused_heads_plain
    ep._epilogue_kernel = ep.conv_epilogue_plain
    try:
        yield
    finally:
        (qb._blend_kernel, qb._spread_kernel, ups._up2x_kernel, ups._adjoint_kernel,
         hd._heads_kernel, ep._epilogue_kernel) = saved


@torch.no_grad()
def calibrate_norms(model: torch.nn.Module, rgb: torch.Tensor, seed: int = 1) -> torch.nn.Module:
    """``model``'s BatchNorms given scales in [0.5, 1.5) and shifts of 0.3
    N(0, 1) (seeded), and as running statistics those of one train-mode
    forward of ``rgb`` without autograd, so that the eval-mode model
    normalizes its features as a trained one does; returns it in eval
    mode."""
    g = torch.Generator().manual_seed(seed)
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        c = m.num_features
        m.weight.copy_(0.5 + torch.rand(c, generator=g))
        m.bias.copy_(0.3 * torch.randn(c, generator=g))
        m.momentum = 1.0  # the running statistics become the batch's
    model.train()(rgb)
    for m, momentum in zip(norms, momenta):
        m.momentum = momentum
    return model.eval()


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matmuls without TF32, and cuDNN deterministic."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32, torch.get_float32_matmul_precision(),
             cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32 = mm.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
        cudnn.deterministic, cudnn.benchmark = saved[3:]


def compare(got: torch.Tensor, want, atol: float, rtol: float = 0.0, chunk=None):
    """(largest |got - want|, whether every element is within atol + rtol *
    |want|, or bit for bit (``torch.equal``) where both are 0). ``want`` is
    a tensor or, for a result too large to hold beside its plain version, a
    function of a slice of dim 0, called ``chunk`` rows at a time."""
    step = chunk or got.shape[0]
    err, ok = 0.0, True
    for i in range(0, got.shape[0], step):
        rows = slice(i, i + step)
        w = want(rows) if callable(want) else want[rows]
        if atol == rtol == 0:
            ok = ok and torch.equal(got[rows], w)
        w = w.float()
        e = (got[rows].float() - w).abs()
        ok = ok and bool((e <= atol + rtol * w.abs()).all())
        err = max(err, e.max().item())
    return err, ok


def heads_gap(got, want, x, pred_weight, pred_bias, conf_weight, conf_bias,
              chunk: int = 64) -> dict:
    """How far two versions of the fused heads (``ops/heads.py``) on the
    map ``x`` lie apart, ``got`` and ``want`` each (pred, conf), in units of
    what rounding alone allows them. Each version sums an output's 288
    products and its bias in f32, at most 289 u sum|terms| from the exact
    sum (u = 2^-24); a bf16 map's plain version rounds the sum to bf16, and
    the sum with its bias again, and the kernel rounds once after the
    activation, each within 2^-8 of the value rounded (f32: 2^-23); the
    ReLU moves no error and the sigmoid quarters it, then rounds its own
    result. ``bound_ratio`` at most 1: rounding alone. Computed in float64
    on ``x``'s device, ``chunk`` maps at a time."""
    import torch.nn.functional as F

    u, r = 2.0**-24, (2.0**-8 if x.dtype == torch.bfloat16 else 2.0**-23)
    w = torch.cat([pred_weight, conf_weight]).to(x.dtype).double()
    b = torch.cat([pred_bias, conf_bias]).to(x.dtype).double()[:, None, None]
    k = pred_weight.shape[0]
    ratio, err = 0.0, 0.0
    for i in range(0, x.shape[0], chunk):
        rows = slice(i, i + chunk)
        xi = x[rows].double()
        conv = F.conv2d(xi, w, padding=1)
        y = conv + b
        e = 2 * 289 * u * (F.conv2d(xi.abs(), w.abs(), padding=1) + b.abs())
        e = e + 2 * r * (conv.abs() + y.abs())
        bound = torch.cat([e[:, :k], e[:, k:] / 4 + 4 * r * torch.sigmoid(y[:, k:]) + 1e-7], 1)
        diff = (torch.cat([got[0][rows], got[1][rows]], 1).double()
                - torch.cat([want[0][rows], want[1][rows]], 1).double()).abs()
        ratio = max(ratio, float((diff / bound).max()))
        err = max(err, float(diff.max()))
    return {"bound_ratio": ratio, "max_abs_err": err}


def heads_params(n_out: int, g: torch.Generator) -> tuple:
    """Seeded f32 parameters of heads with ``n_out`` outputs on ``g``'s
    device: (pred weight, pred bias, conf weight, conf bias), weights at
    the scale of PyTorch's default init, so that both heads stay live."""
    dev = g.device
    return (torch.randn(n_out - 1, 32, 3, 3, device=dev, generator=g) * 0.06,
            torch.randn(n_out - 1, device=dev, generator=g) * 0.5,
            torch.randn(1, 32, 3, 3, device=dev, generator=g) * 0.06,
            torch.randn(1, device=dev, generator=g) * 0.5)


def tame_heads(state_dict, scale: float = HEAD_SCALE) -> dict:
    """Random weights saturate the heads: most of the ReLU depth is 0 and
    takes no gradient, and the sigmoid confidence is 1, so the merge's
    weighting takes none either. Scaling both head kernels and offsetting
    the depth bias keeps both heads in their live range, so that the whole
    backward of the merge is exercised, as in the CPU tests
    (tests/test_torch_port_train.py)."""
    sd = dict(state_dict)
    for head in ("pred", "weight_pred"):
        sd[f"{head}.weight"] = sd[f"{head}.weight"] * scale
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
    """The arguments of loss_and_grads in float64 (the model in place, its
    buffers too)."""
    model = model.double()
    return (model, {k: v.double() if v.is_floating_point() else v for k, v in batch.items()},
            {k: v.double() if v.is_floating_point() else v for k, v in state_dict.items()})


def loss_and_grads(model, batch, state_dict, train: bool = True,
                   confidence: bool = True) -> tuple[float, dict]:
    """One forward, loss and backward from ``state_dict``: in train mode
    (the train step's), or with the BatchNorms on the running statistics of
    ``state_dict``. The loss: BerHu, or for a batch with labels (a
    segmentation model) the cross-entropy that ignores -1. The iterative
    model's loss is the mean over its passes, as the trainer's; the
    gradients of the parameters that take none (its confidence head without
    ``confidence``) are left out."""
    from omnifusion_torch.losses import berhu_loss
    from omnifusion_torch.models import cross_entropy_ignore
    from omnifusion_torch.training import forward_loss, seg_forward_loss

    model.load_state_dict(state_dict)
    model.zero_grad(set_to_none=True)
    seg = "labels" in batch
    if train:
        loss, _ = seg_forward_loss(model, batch) if seg else forward_loss(model, batch, confidence)
    elif seg:
        loss = cross_entropy_ignore(model.eval()(batch["rgb"]), batch["labels"])
    else:
        out = model.eval()(batch["rgb"], confidence=confidence)
        preds = out if isinstance(out, list) else [out]
        loss = torch.stack([berhu_loss(p, batch["depth"], batch["mask"]) for p in preds]).mean()
    loss.backward()
    return loss.item(), {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
                         if p.grad is not None}


def grad_parity(a, b) -> dict:
    (la, ga), (lb, gb) = a, b
    rels = {n: float((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)) for n in gb}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    return {"loss": la, "loss_ref": lb, "loss_rel": abs(la / lb - 1),
            "grad_rel_max": max(rels.values()), "grad_rel_median": float(np.median(list(rels.values()))),
            "grad_rel_worst": worst, "tensors": len(rels)}


def step_parity(ours, ref, f64, ref_nudged, loss_tol: float = LOSS_TOL) -> tuple[dict, bool]:
    """``ours`` against ``ref`` (loss_and_grads results) with the witnesses
    of the tolerance comment: ``f64``, the same step in float64, and
    ``ref_nudged``, ``ref`` on the nudged batch; the loss within
    ``loss_tol``, relative. Returns the numbers and whether they hold."""
    par, near, far = grad_parity(ours, ref), grad_parity(ours, f64), grad_parity(ref, f64)
    wit = grad_parity(ref, ref_nudged)
    out = {**par, "ours_vs_f64": near, "ref_vs_f64": far, "ref_vs_ref_nudged": wit}
    # ref may land nearer float64 than its own move under the nudge (an
    # order of sums that happens to round well): then that move is the scale
    ok = (par["loss_rel"] < loss_tol
          and all(near[k] <= F64_RATIO * max(far[k], wit[k])
                  for k in ("grad_rel_max", "grad_rel_median"))
          and par["grad_rel_max"] <= ULP_RATIO * wit["grad_rel_max"])
    return out, ok


def _row(rows: list, name: str, got, want, atol: float, rtol: float = 0.0) -> None:
    torch.cuda.synchronize()
    err, ok = compare(got, want, atol, rtol)
    rows.append({"check": name, "ok": ok, "max_abs_err": err, "atol": atol, "rtol": rtol})


def kernel_checks(device) -> list[dict]:
    from omnifusion_torch.ops.heads import OUTPUTS, fused_heads, fused_heads_plain
    from omnifusion_torch.ops.probe import probe, probe_plain
    from omnifusion_torch.ops.quad_blend import (
        quad_blend, quad_blend_plain, quad_spread, quad_spread_plain,
    )
    from omnifusion_torch.ops.upsample import up2x, up2x_adjoint, up2x_adjoint_plain, up2x_plain
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables

    spec = ProjectionSpec.create(ERP, PATCH, (80.0, 80.0), 4)
    t_e2p, t_p2e = equi2pers_tables(spec, device), pers2equi_tables(spec, device)
    g = torch.Generator(device=device).manual_seed(0)
    n_erp, b = ERP[0] * ERP[1], BLEND_BATCH
    rows: list[dict] = []
    x_e2p = torch.rand(b, n_erp, 3, device=device, generator=g)
    x_merge = torch.rand(b, 2, t_p2e.n_in, device=device, generator=g)
    for name, x, tables, cl in (("e2p_f32", x_e2p, t_e2p, True),
                                ("e2p_bf16", x_e2p.bfloat16(), t_e2p, True),
                                ("merge_f32", x_merge, t_p2e, False),
                                ("merge_f16", x_merge.half(), t_p2e, False),
                                ("merge_bf16", x_merge.bfloat16(), t_p2e, False)):
        _row(rows, f"quad_blend {name}", quad_blend(x, tables, channel_last=cl),
             quad_blend_plain(x, tables, channel_last=cl), BLEND_TOL)
    atol, rtol = SPREAD_TOL[torch.float32]
    for name, cot, tables, cl in (
            ("merge", torch.rand(b, 2, n_erp, device=device, generator=g), t_p2e.vjp, False),
            ("e2p", torch.rand(b, t_e2p.n_out, 3, device=device, generator=g), t_e2p.vjp, True)):
        _row(rows, f"quad_spread {name}", quad_spread(cot, tables, channel_last=cl),
             quad_spread_plain(cot, tables, channel_last=cl), atol, rtol)
    p = spec.n_patches
    for c, s in ((512, 1), (128, 2), (64, 4), (64, 8), (32, 16)):  # the decoder at patch 32
        x = torch.rand(8 * p, c, s, s, device=device, generator=g)
        gy = torch.rand(8 * p, c, 2 * s, 2 * s, device=device, generator=g)
        _row(rows, f"up2x {c}x{s}x{s}", up2x(x), up2x_plain(x), UP2X_TOL)
        _row(rows, f"up2x {c}x{s}x{s} bf16", up2x(x.bfloat16()), up2x_plain(x.bfloat16()),
             1e-6, UP2X_BF16_RTOL)
        for gy_t in (gy, gy.bfloat16()):
            _row(rows, f"up2x_adjoint {c}x{2 * s}x{2 * s} {str(gy_t.dtype)[6:]}",
                 up2x_adjoint(gy_t), up2x_adjoint_plain(gy_t), 0.0)
    x = torch.randn(256, 128, device=device, generator=g) * 1e3
    _row(rows, "probe", probe(x), probe_plain(x), 0.0)
    for n_out in OUTPUTS:  # the heads at the decoder's last stage, patch 32 (through the copy)
        params = heads_params(n_out, g)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(8 * p, 32, PATCH, PATCH, device=device, generator=g).to(dtype)
            act = "relu" if n_out == 2 else "none"
            got = fused_heads(x, *params, act)
            with full_f32():  # cuDNN's TF32 would make the f32 plain version the coarser
                want = fused_heads_plain(x, *params, act)
            gap = heads_gap(got, want, x, *params)
            rows.append({"check": f"fused_heads {n_out} outputs {str(dtype)[6:]}",
                         "ok": gap["bound_ratio"] <= 1, **gap})
    return rows


def composed_check(device) -> dict:
    """One train step of the small model on the kernels against the plain
    versions, with the float64 and nudged witnesses."""
    from omnifusion_torch.models import SphericalFusion, init_weights
    from omnifusion_torch.projection import ProjectionSpec

    spec = ProjectionSpec.create(ERP, PATCH, (80.0, 80.0), 4)
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.random((TRAIN_BATCH, *ERP, 3), dtype=np.float32),
             "depth": (rng.random((TRAIN_BATCH, *ERP, 1)) * 7 + 0.3).astype(np.float32),
             "mask": np.ones((TRAIN_BATCH, *ERP, 1), np.float32)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model = init_weights(SphericalFusion(spec, depth=2, encoder_stages=ONE_BLOCK, device=device), 0)
    sd0 = tame_heads(copy.deepcopy(model.state_dict()))
    with full_f32():
        kern = loss_and_grads(model, batch, sd0)
        with plain_versions():
            plain = [loss_and_grads(model, b, sd0) for b in (batch, nudged(batch, 5))]
            f64 = loss_and_grads(*as_f64(model, batch, sd0))
    par, ok = step_parity(kern, plain[0], f64, plain[1])
    norms = [float(torch.sqrt(sum(g.square().sum() for g in r[1].values()))) for r in (kern, plain[0])]
    gn_rel = abs(norms[0] / norms[1] - 1)
    par.update(grad_norm=norms[0], grad_norm_ref=norms[1], grad_norm_rel=gn_rel)
    return {"check": "composed train step", "ok": ok and gn_rel < LOSS_TOL, "parity": par,
            "loss_tol": LOSS_TOL, "f64_ratio": F64_RATIO, "ulp_ratio": ULP_RATIO}


def run(args) -> dict:
    from omnifusion_torch.utils.profiling import gpu_line

    if not torch.cuda.is_available():
        raise SystemExit("verify_kernels: no CUDA device; the kernels run only on the card "
                         "(their plain versions are held against the JAX package by the "
                         "CPU tests)")
    device = torch.device("cuda")
    rows = [] if args.only_model else kernel_checks(device)
    if not args.skip_model:
        rows.append(composed_check(device))
    return {"tool": "verify_kernels", "rows": rows, "failures": sum(not r["ok"] for r in rows),
            "device": torch.cuda.get_device_name(device), "gpu": gpu_line()}


def main(argv=None) -> int:
    out = run(build_parser().parse_args(argv))
    for r in out["rows"]:
        if "parity" in r:
            p = r["parity"]
            print(f"{'PASS' if r['ok'] else 'FAIL'}  {r['check']:34s} loss rel {p['loss_rel']:.2e}"
                  f"  grad norm rel {p['grad_norm_rel']:.2e}  grad rel max {p['grad_rel_max']:.2e}"
                  f" (nudge {p['ref_vs_ref_nudged']['grad_rel_max']:.2e})", flush=True)
        else:
            if "bound_ratio" in r:
                tol = f"{r['bound_ratio']:.3f} of rounding's bound"
            elif r["atol"] or r["rtol"]:
                tol = f"tol {r['atol']:g} + {r['rtol']:g} |want|"
            else:
                tol = "bitwise"
            print(f"{'PASS' if r['ok'] else 'FAIL'}  {r['check']:34s} max|delta| = "
                  f"{r['max_abs_err']:.3e}  ({tol})", flush=True)
    print("ALL PASS" if not out["failures"] else f"{out['failures']} FAILURES", flush=True)
    print(json.dumps(out), flush=True)
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
