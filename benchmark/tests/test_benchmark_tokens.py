"""The transformer's own check (``modes/serve_batched_tokens.py``): the
reference on the tokens the program took in, its controls, and the hook
that holds the tokens."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, weights
from benchmark.modes import serve_batched_tokens as mode
from benchmark.reference import model as ref

CELL = "oneshot_s2d3d_p256.batched_b64"


def small():
    """The cell's configuration at patch 64: 2x2 layer4, 128-wide tokens."""
    cfg = harness.load_cell(CELL, overrides={"patch_size": [64, 64]}).config
    state = weights.make(cfg, 11, "cpu")
    params = {k: v for k, v in state.items() if k.startswith("transformer.")}
    return cfg, state, params


def port_transformer(cfg, params):
    from omnifusion_torch.models.transformer import TransformerCascade

    emb = ref.token_size(cfg)[0]
    m = TransformerCascade(emb, cfg["n_patches"], cfg["transformer_depth"], cfg["num_heads"])
    m.load_state_dict({k[len("transformer."):]: v for k, v in params.items()})
    return m.eval()


def test_reference_tokens_of_f32_tokens_are_the_reference_transformer():
    cfg, _, params = small()
    tok = torch.randn(2, cfg["n_patches"], ref.token_size(cfg)[0],
                      generator=torch.Generator().manual_seed(1))
    assert torch.equal(mode.reference_tokens(cfg, params, tok), ref.transformer(params, cfg, tok))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_port_transformer_reads_no_gap_and_the_controls_do(dtype):
    """The port's transformer on the CPU is the reference's arithmetic; its
    bf16 tokens take the embedding in bf16, as the reference adds it. A
    TF32 and a bf16 transformer read gaps far above it, bf16 the larger."""
    cfg, state, params = small()
    m = port_transformer(cfg, params)
    held = []
    with torch.inference_mode():
        tok = torch.randn(2, cfg["n_patches"], ref.token_size(cfg)[0],
                          generator=torch.Generator().manual_seed(2)).to(dtype)
        held.append((tok, m(tok)))
    gaps = mode.token_gaps(cfg, state, held, "cpu", mode.CONTROLS)
    assert max(gaps["program"]) < 1e-6
    assert 1e-4 < min(gaps["tf32"]) and max(gaps["tf32"]) < min(gaps["bf16"]) < 1e-2


def test_holding_records_each_call_of_the_model_transformer_until_removed():
    cfg, _, params = small()
    model = torch.nn.Module()
    model.transformer = port_transformer(cfg, params)
    held = []
    tok = torch.randn(1, cfg["n_patches"], ref.token_size(cfg)[0])
    with torch.inference_mode():
        hook = mode.holding(model, held)
        out = model.transformer(tok)
        hook.remove()
        model.transformer(tok)
    assert len(held) == 1 and torch.equal(held[0][0], tok) and torch.equal(held[0][1], out)
    with pytest.raises(ValueError, match="no transformer"):
        mode.holding(torch.nn.Linear(2, 2), [])


@pytest.mark.parametrize("kind", ["tf32", "bf16"])
def test_rounded_products_round_the_operands_of_products_only(kind):
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(4, 8, generator=g), torch.randn(5, 8, generator=g)
    b = torch.randn(5, generator=g)
    y = torch.randn(8, 3, generator=g)
    with mode.rounded_products(kind):
        lin, mm, add = F.linear(x, w, b), x @ y, x + 1.0
    assert torch.equal(lin, F.linear(ref.rounded(x, kind), ref.rounded(w, kind), b))
    assert torch.equal(mm, ref.rounded(x, kind) @ ref.rounded(y, kind))
    assert torch.equal(add, x + 1.0) and not torch.equal(lin, F.linear(x, w, b))
