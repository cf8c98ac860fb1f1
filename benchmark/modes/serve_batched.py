"""Batched serving: a closed loop that sends batches back to back.

The window drives the model's forward (``SphericalFusion.forward`` or
``SphericalFusionIterative.forward``, eval mode, ``inference_mode``, as
``cli/infer.py`` serves) over a pool of distinct seeded batches held on
the device, cycled; the depth stays on the device. The rate is every
panorama of the window over the window's time, which ends at a
synchronize. The answers of the steps ``generator.sampled`` draws from the
seed, and of the last step, are kept (every pass's depth) and compared
with the reference once the window has closed.
"""

from __future__ import annotations

import time

import torch

from benchmark import check, generator, harness, program, weights


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    ctx.mark("import")
    state = weights.make(cfg, generator.stream_seed(ctx.seed, generator.WEIGHTS), dev)
    ctx.mark("weights")
    model = program.build_model(cfg, tr["precision"], state, dev).eval()
    state = {k: v.cpu() for k, v in state.items()}
    ctx.mark("model")
    pool = generator.erp_pool(cfg, tr, ctx.seed, dev)
    n_pool, batch = len(pool), tr["batch"]
    ctx.mark("inputs")
    with torch.inference_mode():
        for _ in range(tr["warmup_rounds"]):
            for x in pool:
                program.depths(model(x))
        ctx.sync()
        ctx.mark("warm-up")
        setup_s = ctx.settle()

        keep = set(generator.sampled(tr, ctx.seed))
        kept, n = {}, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            out = program.depths(model(pool[n % n_pool]))
            if n in keep:
                kept[n] = out
            n += 1
        ctx.sync()
        window = time.perf_counter() - t0
        kept[n - 1] = out
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    t_trace = time.perf_counter()
    trace = None
    if ctx.trace:
        with torch.inference_mode():
            trace = harness.trace_window(lambda i: model(pool[i % n_pool]), tr["trace_steps"], dev)
    del model, out
    if dev == "cuda":
        torch.cuda.empty_cache()

    pairs = [(pool[i % n_pool], d) for i, d in sorted(kept.items())]
    t_check = time.perf_counter()
    errs = check.serve_gaps(cfg, state, pairs, dev, block=tr["check_block"])["program"]
    limit = ctx.cell.limits["limits"]["depth_gap"]
    return harness.Outcome(
        e2e={"serve_panos_per_s": n * batch / window, "setup_s": setup_s},
        attempted=n * batch,
        failed=sum(e > limit for e in errs),
        checks=[harness.Check("depth_gap", max(errs), limit)],
        memory_peak_bytes=peak,
        facts={"batch": batch, "panos_per_s": n * batch / window, "steps": n,
               "phase_s": {"window": window, "trace": t_check - t_trace,
                           "check": time.perf_counter() - t_check}},
        trace=trace,
    )
