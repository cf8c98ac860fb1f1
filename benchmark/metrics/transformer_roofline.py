"""``transformer_roofline.<suffix>`` (%): the transformer blocks' share of
the card's f32 peak in the traced window.

The bound is counted from the cell's shapes alone (``flops``): the FLOPs
of the reference's ``transformer`` (``benchmark/reference/model.py``: the
positional embedding, the pre-norm blocks and the last norm; its linear
maps and the attention's two products) over (batch, n_patches, token
width) tokens, by ``torch.utils.flop_counter.FlopCounterMode`` on the meta
device, times the kind's passes. The recipe runs the blocks in f32 without
TF32, on the CUDA cores, so the peak is ``yardstick.PEAK_FLOPS["f32"]``.
The share is that bound over the device time a step of the program's span
``transformer_blocks`` (``harness.span_window``'s profiled window) times
the peak. None off the card or where the span did not open.
"""

import torch

from benchmark import yardstick
from benchmark.reference import model as ref

SPAN = "transformer_blocks"


def flops(cfg, batch: int) -> float:
    """The reference transformer's FLOPs over one pass's tokens at ``batch``."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    emb, _, _ = ref.token_size(cfg)
    p = {name: torch.empty(shape, device=meta) for name, shape, _ in ref.kind(cfg).param_specs(cfg)
         if name.startswith("transformer.")}
    tok = torch.empty(batch, cfg["n_patches"], emb, device=meta)
    counter = FlopCounterMode(display=False)
    with counter:
        ref.transformer(p, cfg, tok)
    return float(counter.get_total_flops())


def read(cell, out, name):
    s = out.spans
    if s is None or not s.on_card:
        return None
    ms = s.device_ms.get(SPAN)
    if not ms:
        return None
    cfg = cell.config
    bound = ref.kind(cfg).passes(cfg) * flops(cfg, out.facts["batch"])
    return 100.0 * bound / (1e-3 * ms * yardstick.PEAK_FLOPS["f32"])
