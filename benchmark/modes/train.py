"""Training: the kind's train step (``training.train_step`` for the depth
models) on one ``create_train_state``, back to back.

Set-up builds the train state once, with the benchmark's weights, and
drives it through the window's own call and feed for ``first_steps``
steps on distinct seeded batches of a pool on the device: the first three
are the ones the reference follows (their losses, the first gradient as
AdamW's first moment holds it after step one, each leaf's change after
step three), the rest warm up. The window then goes on stepping the same
state, cycling the pool, and ends at a synchronize. The rate is every
panorama of the window over the window's time.
"""

from __future__ import annotations

import time

import torch

from benchmark import check, generator, harness, program, weights
from benchmark.reference import model as ref

COMPARED_STEPS = 3
# the CPU tests' sizes of the mix (benchmark/tests/small.py)
SMALL = {"batch": 2, "pool": 3, "first_steps": 3, "trace_steps": 1}


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    kind = program.kind(cfg)
    ctx.mark("import")
    state = weights.make(cfg, generator.stream_seed(ctx.seed, generator.WEIGHTS), dev)
    ctx.mark("weights")
    model = kind.build(cfg, tr["precision"], state, dev)
    state = {k: v.cpu() for k, v in state.items()}
    ctx.mark("model")
    ts = program.train_state(model, tr)
    pool = generator.train_pool(cfg, tr, ctx.seed, dev)
    n_pool, batch = len(pool), tr["batch"]
    ctx.mark("inputs")
    prog = first_steps(kind, ts, pool, tr["first_steps"], state, dev)
    ctx.sync()
    ctx.mark("first steps")
    setup_s = ctx.settle()

    n = tr["first_steps"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        kind.train_step(ts, pool[n % n_pool])
        n += 1
    ctx.sync()
    window = time.perf_counter() - t0
    steps = n - tr["first_steps"]
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0

    t_trace = time.perf_counter()
    trace = spans = None
    if ctx.trace:
        trace = harness.trace_window(lambda i: kind.train_step(ts, pool[i % n_pool]),
                                     tr["trace_steps"], dev)
        spans = harness.span_window(lambda i: kind.train_step(ts, pool[i % n_pool]),
                                    tr["trace_steps"], dev, ctx.setup_record)
    del model, ts
    if dev == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    geom = ref.Geometry(cfg, dev)
    refr = check.reference_train(cfg, tr["recipe"], state, pool[:COMPARED_STEPS], dev, geom=geom)
    unit = check.reference_unit(cfg, tr["recipe"], state, pool[:1], dev, geom)
    gaps = check.train_gaps(prog, refr, unit)
    limits = ctx.cell.limits["limits"]
    checks = [harness.Check(k, gaps[k], limits[k]) for k in check.TRAIN_NUMBERS]
    return harness.Outcome(
        e2e={"train_panos_per_s": steps * batch / window, "setup_s": setup_s},
        attempted=steps * batch,
        failed=0,
        checks=checks,
        memory_peak_bytes=peak,
        facts={"batch": batch, "panos_per_s": steps * batch / window, "steps": steps,
               "phase_s": {"window": window, "trace": t_check - t_trace,
                           "check": time.perf_counter() - t_check}},
        trace=trace,
        spans=spans,
    )


def first_steps(kind, ts, pool, n_steps, state0, device) -> dict:
    """Drive the train state ``ts`` through its first ``n_steps`` steps (the
    train step of ``kind``, ``benchmark/models/<model>.py``) on the pool's
    batches and read what the reference follows: the first
    three steps' losses, each leaf's first gradient as AdamW's first moment
    holds it after step one (its norm, and its values on the host), each
    leaf's change from ``state0`` (host tensors) after step three."""
    model = ts.model
    beta1 = ts.optimizer.param_groups[0]["betas"][0]
    params = dict(model.named_parameters())
    losses, grad, change = [], {}, {}
    for i in range(n_steps):
        out = kind.train_step(ts, pool[i % len(pool)])
        if i < COMPARED_STEPS:
            losses.append(out["loss"])
        if i == 0:
            grad = {k: (ts.optimizer.state[p]["exp_avg"] / (1 - beta1)).to("cpu")
                    for k, p in params.items() if p in ts.optimizer.state}
        if i == COMPARED_STEPS - 1:
            change = {k: (p.detach() - state0[k].to(device)).norm() for k, p in params.items()}
    return {"loss": [x.item() for x in losses], "grad": {k: v.norm().item() for k, v in grad.items()},
            "change": {k: v.item() for k, v in change.items()}, "grad_values": grad}
