"""Batched serving with the transformer checked alone: ``serve_batched``'s
closed loop and its check of the served output, and a second check,
``token_gap``, of the transformer by itself.

The output's check (``check.serve_gaps``) counts the gap in units of the
gap that rounding the reference's operands to the kind's recipe makes. The
recipe's bf16 convolutions make most of that unit, so a transformer in a
lower precision than the configuration's f32 hardly moves it (PERF.md). So
on the steps ``generator.sampled`` draws, the window also holds the tokens
the model's transformer (its ``transformer`` module, the
``TransformerCascade`` call) took in and gave out in that timed forward
(``holding``). Once the window has closed, the reference's transformer
(``reference/model.py: transformer``, f32, TF32 off) runs on the tokens
taken in, with the positional embedding added in their dtype, as the
recipe adds it (bf16 tokens stay bf16 through that add;
``omnifusion_torch/models/transformer.py``). ``token_gap`` is the worst of
those panoramas' relative L2 gap of the tokens given out from the
reference's: a bare gap, not in units, since an f32 transformer's own
rounding is all that should part them.

The controls are the reference's transformer with the operands of its
matrix products (the linear maps and attention's two products) rounded
to TF32, the precision below f32 the card's GEMMs offer, or to bf16, and
their products summed in f32 (``rounded_products``).
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.nn.functional as F

from benchmark import check, generator, harness, program, weights
from benchmark.reference import model as ref

# the CPU tests' sizes of the mix (benchmark/tests/small.py): the one
# compared step is the first, so every window holds one
SMALL = {"batch": 2, "pool": 2, "check_among": 1, "check_count": 1, "trace_steps": 1,
         "warmup_rounds": 1}
CHECK = "token_gap"
# the transformers below the configuration's f32, each in the program's
# place (benchmark/calibrate_tokens.py)
CONTROLS = ("tf32", "bf16")
# the matrix products the reference's transformer makes (a @ b is Tensor.matmul)
PRODUCTS = (F.linear, torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


def holding(model, into: list):
    """A forward hook on the model's transformer that appends (tokens in,
    tokens out) of each call to ``into``; returns its handle: remove it
    after the forward."""
    blocks = getattr(model, "transformer", None)
    if not isinstance(blocks, torch.nn.Module):
        raise ValueError(f"{type(model).__name__} has no transformer to hold")

    def held(module, args, out):
        into.append((args[0].detach().clone(), out.detach().clone()))

    return blocks.register_forward_hook(held)


class rounded_products(torch.overrides.TorchFunctionMode):
    """While active, the two operands of every matrix product
    (``PRODUCTS``) are rounded to ``kind`` (``ref.rounded``) first; a
    linear map's bias is added unrounded."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            args = (ref.rounded(args[0], self.kind), ref.rounded(args[1], self.kind), *args[2:])
        return func(*args, **(kwargs or {}))


def reference_tokens(cfg, params, tok, kind="f32"):
    """The reference's transformer on ``tok`` (B, P, emb) as the program's
    transformer took it in: the positional embedding added in ``tok``'s
    dtype, then the blocks in f32, their products' operands rounded to
    ``kind``. ``params``: the reference's ``transformer.*`` tensors, f32 on
    ``tok``'s device."""
    pos = params["transformer.pos_emb"]
    x = (tok + pos.to(tok.dtype)).float()
    p = dict(params, **{"transformer.pos_emb": torch.zeros_like(pos)})  # x + 0 is x
    ctx = contextlib.nullcontext() if kind == "f32" else rounded_products(kind)
    with ctx:
        return ref.transformer(p, cfg, x)


def token_gaps(cfg, state, held, device, controls=()) -> dict:
    """Per panorama, the relative L2 gap of the tokens out of each (tokens
    in, tokens out) in ``held`` (on any device) from the reference's f32
    transformer on the tokens in, under "program"; and of the reference's
    transformer with its products rounded to each kind of ``controls``,
    put in the program's place, under that kind."""
    params = {k: v.to(device).float() for k, v in state.items() if k.startswith("transformer.")}
    gaps = {"program": [], **{c: [] for c in controls}}
    with check.no_tf32(), torch.inference_mode():
        for tok, out in held:
            tok = tok.to(device)
            r = reference_tokens(cfg, params, tok)
            gaps["program"] += check.rel_l2(out.to(device), r)
            for c in controls:
                gaps[c] += check.rel_l2(reference_tokens(cfg, params, tok, c), r)
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
        kept, tokens, n = {}, {}, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            if n in keep:
                hook = holding(model, tokens.setdefault(n, []))
            out = kind.outputs(model(pool[n % n_pool]))
            if n in keep:
                hook.remove()
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
    limit, t_limit = ctx.cell.limits["limits"][name], ctx.cell.limits["limits"][CHECK]
    held = sorted(tokens)
    if any(len(tokens[i]) != 1 for i in held):
        raise RuntimeError(f"the transformer ran {[len(tokens[i]) for i in held]} times in the "
                           "held forwards, not once")
    t_errs = token_gaps(cfg, state, [tokens[i][0] for i in held], dev)["program"]
    bad = [e > limit for e in errs]  # a panorama a compared step, in the order of steps
    for k, i in enumerate(held):
        at = steps.index(i) * batch
        for j, e in enumerate(t_errs[k * batch:(k + 1) * batch]):
            bad[at + j] = bad[at + j] or e > t_limit
    return harness.Outcome(
        e2e={"serve_panos_per_s": n * batch / window, "setup_s": setup_s},
        attempted=n * batch,
        failed=sum(bad),
        checks=[harness.Check(name, max(errs), limit),
                harness.Check(CHECK, max(t_errs, default=float("nan")), t_limit)],
        memory_peak_bytes=peak,
        facts={"batch": batch, "panos_per_s": n * batch / window, "steps": n,
               "phase_s": {"window": window, "trace": t_check - t_trace,
                           "check": time.perf_counter() - t_check}},
        trace=trace,
        spans=spans,
    )
