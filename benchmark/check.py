"""The comparison that decides ``correct``: the program's answers against
the plain reference (``benchmark/reference/``), run once the window has
closed, the program freed, in blocks of panoramas.

Serving: for each compared panorama and each pass of the forward (the
last pass is the served depth), the relative L2 gap of the depth from the
f32 reference's, ||d - r|| / ||r|| over its pixels, in units of the gap
that rounding the reference's operands to the configuration's precision
makes (``RECIPE``: bf16 convolutions, an f16 merge): a random network's
conditioning moves both gaps together from seed to seed, so their ratio
is steady. The number compared, ``depth_gap``, is the worst ratio over
the compared panoramas and passes.

Training: the reference follows the program's first three steps from the
same weights on the same batches (f32, TF32 off, its own BerHu, AdamW and
schedule). Compared: ``loss_gap``, the worst step's relative loss gap;
by the worst leaf, the gap between the program's and the reference's norm
of the first gradient (the program's read from AdamW's first moment after
one step, exp_avg / (1 - beta1)), ``grad_gap``, and of each leaf's change
over the three steps, ``change_gap``, each over the larger of the
reference's norm of that leaf and of the median leaf; and ``grad_diff``:
the median over the leaves of ||g - g_ref|| / ||g_ref|| (the first
gradients), in units of the same median for the reference's first step
computed in the configuration's own precision (``UNIT_TRAIN``: on the
card, PyTorch's TF32 convolutions; on the CPU, which has none, their
operands rounded to TF32). A gap of norms is blind to the rounding of a
lower precision (second order in an error that is not biased; Adam's
step moves each element by about the rate whatever its gradient), and a
bare difference moves with each seed's conditioning, so only
``grad_diff`` tells the configuration's precision from the one below it
(PERF.md). Leaves whose reference gradient is under
a thousandth of the median leaf's move by round-off alone and are left
out of all three leaf measures.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import model as ref

NEGLIGIBLE = 1e-3  # of the median leaf's gradient norm
TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_diff")


@contextlib.contextmanager
def no_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


RECIPE = ref.Precision(convs="bf16", merge="f16")
UNIT_TRAIN = ref.Precision(convs="tf32")
CONTROL = ref.Precision(convs="fp8", merge="fp8")


def reference_depth(cfg, state, geom, rgb, prec=ref.Precision(), block=8):
    """The reference's depth of each pass of rgb (B, H, W, 3)."""
    outs = []
    with no_tf32(), torch.inference_mode():
        for i in range(0, rgb.shape[0], block):
            outs.append(ref.forward(state, cfg, geom, rgb[i:i + block].float(), prec))
    return [torch.cat(p) for p in zip(*outs)]


def rel_l2(d: torch.Tensor, r: torch.Tensor) -> list[float]:
    """Per panorama ||d - r|| / ||r||, in float64."""
    d, r = d.double().flatten(1), r.double().flatten(1)
    return ((d - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)).tolist()


def serve_gaps(cfg, state, pairs, device, block=8, controls=(), geom=None) -> dict:
    """Per-panorama ``depth_gap`` of the outputs in ``pairs`` ((rgb, the
    depth of each pass), on any device), under "program"; and of the
    reference computed in each Precision of ``controls`` put in the
    program's place, under its repr."""
    geom = geom or ref.Geometry(cfg, device)
    state = {k: v.to(device) for k, v in state.items()}
    gaps = {"program": [], **{repr(c): [] for c in controls}}
    for rgb, passes in pairs:
        rgb = rgb.to(device)
        r = reference_depth(cfg, state, geom, rgb, ref.Precision(), block)
        units = [rel_l2(a, b) for a, b in zip(reference_depth(cfg, state, geom, rgb, RECIPE, block), r)]
        served = {"program": [d.to(device) for d in passes]}
        served.update({repr(c): reference_depth(cfg, state, geom, rgb, c, block) for c in controls})
        for key, ds in served.items():
            if len(ds) != len(r):
                raise ValueError(f"{key} gave {len(ds)} passes, the reference {len(r)}")
            per_pass = [[g / max(u, 1e-30) for g, u in zip(rel_l2(d, rr), unit)]
                        for d, rr, unit in zip(ds, r, units)]
            gaps[key] += [max(x) for x in zip(*per_pass)]
    return gaps


def reference_train(cfg, recipe, state, batches, device, prec=ref.Precision(), steps=3,
                    geom=None, tf32=False) -> dict:
    """The reference's first ``steps`` train steps from ``state``:
    {"loss": [per step], "grad": {leaf: norm of step 1's gradient},
    "change": {leaf: norm of the change after ``steps``}, "grad_values":
    {leaf: step 1's gradient}}. ``tf32``: PyTorch's default precision on
    the card (TF32 convolutions) instead of f32."""
    geom = geom or ref.Geometry(cfg, device)
    p0 = {k: v.to(device).float() for k, v in state.items() if v.is_floating_point()
          and not k.endswith(("running_mean", "running_var"))}
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad, values = [], {}, {}
    with contextlib.nullcontext() if tf32 else no_tf32():
        for t in range(steps):
            batch = batches[t]
            preds = ref.forward(p, cfg, geom, batch["rgb"], prec, train=True)
            loss = torch.stack([ref.berhu(d, batch["depth"], batch["mask"]) for d in preds]).mean()
            gs = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            losses.append(loss.item())
            lr = ref.cosine_lr(recipe["lr"], recipe["t_0"], recipe["t_mult"],
                               recipe["steps_per_epoch"], t)
            with torch.no_grad():
                for (k, w), g in zip(p.items(), gs):
                    if g is None:
                        continue
                    if t == 0:
                        grad[k] = g.norm().item()
                        values[k] = g.clone()
                    w.mul_(1.0 - lr * recipe["weight_decay"])
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k] / (1 - b2 ** (t + 1))).sqrt_().add_(eps)
                    w.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** (t + 1)))
    change = {k: (p[k].detach() - p0[k]).norm().item() for k in grad}
    return {"loss": losses, "grad": grad, "change": change, "grad_values": values}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def train_gaps(prog: dict, refr: dict, unit: dict | None = None) -> dict:
    """loss_gap, grad_gap, change_gap and, given the reference's first step
    in the configuration's precision (``reference_unit``), grad_diff of
    the program's readings against the reference's (the module's
    docstring)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], refr["loss"]))
    med = _median(list(refr["grad"].values()))
    leaves = [k for k, g in refr["grad"].items() if g >= NEGLIGIBLE * med]

    def worst(key):
        m = _median([refr[key][k] for k in leaves])
        return max(abs(prog[key].get(k, 0.0) - refr[key][k]) / max(refr[key][k], m)
                   for k in leaves)

    out = {"loss_gap": loss_gap, "grad_gap": worst("grad"), "change_gap": worst("change")}
    if unit is not None:
        out["grad_diff"] = grad_diff_median(prog, refr, leaves) / max(
            grad_diff_median(unit, refr, leaves), 1e-30)
    return out


def grad_diff_median(prog, refr, leaves) -> float:
    """The median over ``leaves`` of ||g - g_ref|| / ||g_ref|| of the first
    gradients."""
    rel = []
    for k in leaves:
        r = refr["grad_values"][k]
        p = prog["grad_values"].get(k)
        p = torch.zeros_like(r) if p is None else p.to(r.device, r.dtype)
        rel.append(((p - r).double().norm() / r.double().norm().clamp(min=1e-300)).item())
    return _median(rel)


def reference_unit(cfg, recipe, state, batches, device, geom=None) -> dict:
    """The reference's first step in the configuration's own precision:
    TF32 convolutions on the card, emulated on the CPU."""
    if device == "cuda":
        return reference_train(cfg, recipe, state, batches, device, steps=1, geom=geom, tf32=True)
    return reference_train(cfg, recipe, state, batches, device, UNIT_TRAIN, steps=1, geom=geom)
