"""Batched serving with the merge checked alone: ``serve_batched``'s closed
loop and its check of the served output, and a second check,
``merge_gap``, of the merge by itself.

The output's check (``check.serve_gaps``) counts the gap in units of the
gap that rounding the reference's operands to the kind's recipe makes. The
recipe's bf16 convolutions make most of that unit, so a merge in a lower
precision than the configuration states hardly moves it (PERF.md). So on
the steps ``generator.sampled`` draws, the window also holds what the
model's heads handed its merge (``gather_heads``: each patch's outputs and
confidence, as that timed forward computed them). Once the window has
closed, the reference's merge (the kind's reference ``merge``, f32, TF32
off) runs on them in blocks of panoramas. ``merge_gap`` is the worst of
those panoramas' relative L2 gap of the served output from it: a bare gap,
not in units, since an f32 merge's own rounding is all that should part
them.

The kind's model has ``gather_heads(pred, conf, b)`` and its reference
``merge(geom, cfg, pred, conf, b, prec)``.
"""

from __future__ import annotations

import time

import torch

from benchmark import check, generator, harness, program, weights
from benchmark.reference import model as ref

# the CPU tests' sizes of the mix (benchmark/tests/small.py): the one
# compared step is the first, so every window holds one
SMALL = {"batch": 2, "pool": 2, "check_among": 1, "check_count": 1, "trace_steps": 1,
         "warmup_rounds": 1}
CHECK = "merge_gap"
# the merges below the configuration's f32, each in the program's place
# (benchmark/calibrate_merge.py)
CONTROLS = (ref.Precision(merge="f16"), ref.Precision(merge="bf16"))


def holding(model, into: list):
    """The model's ``gather_heads``, which also appends what it returns to
    ``into``: set it on the model for one forward, then
    ``del model.gather_heads``."""
    gather = type(model).gather_heads.__get__(model)

    def held(*args):
        out = gather(*args)
        into.append(out)
        return out

    return held


def merge_gaps(cfg, held, device, block=8, controls=(), geom=None) -> dict:
    """Per panorama, the relative L2 gap of the served output of each
    ``(pred, conf, served)`` in ``held`` (the heads' rows a forward's merge
    was handed, (B*P, C, h, w) and (B*P, 1, h, w), and what it served, on
    any device) from the reference's f32 merge of those rows, under
    "program"; and of the reference's merge in each Precision of
    ``controls``, put in the program's place, under its repr."""
    geom = geom or ref.Geometry(cfg, device)
    merge, n_p = ref.kind(cfg).merge, cfg["n_patches"]
    gaps = {"program": [], **{repr(c): [] for c in controls}}
    with check.no_tf32(), torch.inference_mode():
        for pred, conf, served in held:
            for i in range(0, served.shape[0], block):
                rows = slice(i * n_p, (i + block) * n_p)
                p, c = pred[rows].to(device).float(), conf[rows].to(device).float()
                b = p.shape[0] // n_p
                r = merge(geom, cfg, p, c, b, ref.Precision())
                gaps["program"] += check.rel_l2(served[i:i + b].to(device), r)
                for ctl in controls:
                    gaps[repr(ctl)] += check.rel_l2(merge(geom, cfg, p, c, b, ctl), r)
    return gaps


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    kind = program.kind(cfg)
    ctx.mark("import")
    state = weights.make(cfg, generator.stream_seed(ctx.seed, generator.WEIGHTS), dev)
    ctx.mark("weights")
    model = kind.build(cfg, tr["precision"], state, dev).eval()
    state = {k: v.cpu() for k, v in state.items()}
    ctx.mark("model")
    pool = generator.erp_pool(cfg, tr, ctx.seed, dev)
    n_pool, batch = len(pool), tr["batch"]
    ctx.mark("inputs")
    with torch.inference_mode():
        for _ in range(tr["warmup_rounds"]):
            for x in pool:
                kind.outputs(model(x))
        ctx.sync()
        ctx.mark("warm-up")
        setup_s = ctx.settle()

        keep = set(generator.sampled(tr, ctx.seed))
        kept, heads, n = {}, {}, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            if n in keep:
                model.gather_heads = holding(model, heads.setdefault(n, []))
            out = kind.outputs(model(pool[n % n_pool]))
            if n in keep:
                del model.gather_heads
                kept[n] = out
            n += 1
        ctx.sync()
        window = time.perf_counter() - t0
        kept[n - 1] = out
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    t_trace = time.perf_counter()
    trace = spans = None
    if ctx.trace:
        with torch.inference_mode():
            trace = harness.trace_window(lambda i: model(pool[i % n_pool]), tr["trace_steps"], dev)
            spans = harness.span_window(lambda i: model(pool[i % n_pool]), tr["trace_steps"], dev,
                                        ctx.setup_record)
    del model, out
    if dev == "cuda":
        torch.cuda.empty_cache()

    steps = sorted(kept)
    pairs = [(pool[i % n_pool], kept[i]) for i in steps]
    t_check = time.perf_counter()
    errs = check.serve_gaps(cfg, state, pairs, dev, block=tr["check_block"])["program"]
    name = ref.kind(cfg).SERVE_CHECK
    limit, m_limit = ctx.cell.limits["limits"][name], ctx.cell.limits["limits"][CHECK]
    merged = sorted(heads)
    m_errs = merge_gaps(cfg, [(*heads[i][0], kept[i][-1]) for i in merged], dev,
                        tr["check_block"])["program"]
    bad = [e > limit for e in errs]  # a panorama a compared step, in the order of steps
    for k, i in enumerate(merged):
        at = steps.index(i) * batch
        for j, e in enumerate(m_errs[k * batch:(k + 1) * batch]):
            bad[at + j] = bad[at + j] or e > m_limit
    return harness.Outcome(
        e2e={"serve_panos_per_s": n * batch / window, "setup_s": setup_s},
        attempted=n * batch,
        failed=sum(bad),
        checks=[harness.Check(name, max(errs), limit),
                harness.Check(CHECK, max(m_errs, default=float("nan")), m_limit)],
        memory_peak_bytes=peak,
        facts={"batch": batch, "panos_per_s": n * batch / window, "steps": n,
               "phase_s": {"window": window, "trace": t_check - t_trace,
                           "check": time.perf_counter() - t_check}},
        trace=trace,
        spans=spans,
    )
