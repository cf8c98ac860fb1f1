"""The benchmark's patch-256 configuration (``benchmark/configs/
oneshot_s2d3d_p256.json``): its ``up_proj`` branch against the plain
reference on the CPU, its sizes on the meta device, and the FLOPs that
``metrics/transformer_roofline.py`` bounds the transformer by.

- The port's f32 ``SphericalFusion`` at 128x256 with patch 64 (layer4 2x2,
  so a 128-wide token unfolds channel-major and folds back through
  ``up_proj``, where the order of its elements matters; patch 32's 1x1
  layer4 cannot tell) gives the reference's depth from the benchmark's
  seeded weights (``benchmark/weights.py``), at the segmentation test's
  bound; a reference that unfolds its token pixel-major fails it.
- At the configuration's own sizes (meta device): the port's state dict has
  the names and shapes of the reference's ``param_specs``, ``up_proj`` and
  the (1, 18, 2048) positional embedding among them, and the transformer's
  blocks hold 302.1 M parameters.
- ``transformer_roofline``'s FLOPs equal the closed form at width 2048, and
  its reading is the bound over the span's device time at the f32 peak.
"""

import pytest
import torch

from benchmark import check, generator, harness, program, weights, yardstick
from benchmark.reference import model as ref
from omnifusion_torch.models import SphericalFusion
from omnifusion_torch.projection import ProjectionSpec

CELL = "oneshot_s2d3d_p256.batched_b64"
F32 = {"trunk": "f32", "merge": "f32"}
BOUND = 1e-4  # the relative L2 gap of tests/test_torch_port_seg_reference.py


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def _small():
    mode = harness.mode_module(harness.load_cell(CELL).traffic["mode"])
    return harness.load_cell(CELL, overrides={"erp_size": [128, 256], "patch_size": [64, 64],
                                              **mode.SMALL})


def _pixel_major(tok, tc, hh, ww):
    """(b, P, tc·hh·ww) channel-major tokens ordered pixel-major."""
    b, p, _ = tok.shape
    return tok.reshape(b, p, tc, hh, ww).permute(0, 1, 3, 4, 2).reshape(b, p, -1)


def _channel_major(tok, tc, hh, ww):
    b, p, _ = tok.shape
    return tok.reshape(b, p, hh, ww, tc).permute(0, 1, 4, 2, 3).reshape(b, p, -1)


def _served_and_reference(seed):
    c = _small()
    cfg = c.config
    kind = program.kind(cfg)
    state = weights.make(cfg, generator.stream_seed(seed, generator.WEIGHTS), "cpu")
    model = kind.build(cfg, F32, state, "cpu").eval()
    assert model.emb == 128 and hasattr(model, "up_proj")
    rgb = generator.erp_pool(cfg, c.traffic, seed, "cpu")[0]
    with torch.inference_mode():
        (d,) = kind.outputs(model(rgb))
    return cfg, state, rgb, d


@pytest.mark.parametrize("seed", [29, 2**38 + 5])
def test_the_port_gives_the_references_depth_through_up_proj(seed):
    cfg, state, rgb, d = _served_and_reference(seed)
    (r,) = check.reference_outputs(cfg, state, ref.Geometry(cfg, "cpu"), rgb)
    assert d.shape == r.shape == (rgb.shape[0], *cfg["erp_size"], 1)
    assert d.dtype == torch.float32
    assert max(check.rel_l2(d, r)) < BOUND
    assert r.std() > 1e-3 * r.abs().mean()  # a depth that is not flat


def test_a_pixel_major_token_fails_the_bound(monkeypatch):
    cfg, state, rgb, d = _served_and_reference(29)
    emb, hh, ww = ref.token_size(cfg)
    tc = cfg["token_channels"]
    blocks = ref.transformer

    def pixel_major(p, cfg, tok):  # the reference with its token unfolded pixel-major
        return _channel_major(blocks(p, cfg, _pixel_major(tok, tc, hh, ww)), tc, hh, ww)

    monkeypatch.setattr(ref, "transformer", pixel_major)
    (r,) = check.reference_outputs(cfg, state, ref.Geometry(cfg, "cpu"), rgb)
    assert min(check.rel_l2(d, r)) > 10 * BOUND


def test_the_state_dict_at_patch_256_has_the_references_names_and_shapes():
    cfg = harness.load_cell(CELL).config
    assert cfg["patch_size"] == [256, 256] and cfg["reduced"] == []
    spec = ProjectionSpec.create(cfg["erp_size"], cfg["patch_size"], cfg["fov"], cfg["nrows"])
    model = SphericalFusion(spec, depth=cfg["transformer_depth"], num_heads=cfg["num_heads"],
                            encoder_stages=[tuple(s) for s in cfg["encoder_stages"]],
                            device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {n: tuple(s) for n, s, _ in ref.kind(cfg).param_specs(cfg)}
    assert got == want
    assert got["up_proj.weight"] == (512, 32, 1, 1) and got["up_proj.bias"] == (512,)
    assert got["transformer.pos_emb"] == (1, 18, 2048)
    emb = 2048
    # a block: two norms, q, kv, the biased proj, fc1 and fc2 (MLP 4 x emb)
    block = 2 * 2 * emb + 4 * emb * emb + emb + 8 * emb * emb + 4 * emb + emb
    blocks = sum(v.numel() for k, v in model.named_parameters() if k.startswith("transformer.layer."))
    assert blocks == 6 * block == 302_112_768 and round(blocks / 1e6, 1) == 302.1
    whole = sum(v.numel() for v in model.parameters())
    assert blocks / whole > 0.92  # the transformer is most of the model


def test_the_transformer_roofline_counts_the_closed_form_at_width_2048():
    cfg = harness.load_cell(CELL).config
    reader = harness.metric_reader("transformer_roofline.batched")
    batch, p, emb, depth = 64, cfg["n_patches"], 2048, cfg["transformer_depth"]
    tokens = batch * p
    # per block: the linear maps' 12 emb^2 multiply-adds a token, and the
    # attention's two products, 2 · batch · p^2 · emb each
    closed = depth * (2 * tokens * 12 * emb**2 + 4 * batch * p * p * emb)
    assert reader.flops(cfg, batch) == pytest.approx(closed, rel=1e-2)
    # the reading: that bound a step over the span's device time at the f32 peak
    spans = harness.Spans(on_card=True, step_ms=0.0, host_ms={},
                          device_ms={reader.SPAN: 14.0})
    out = harness.Outcome(e2e={}, attempted=0, failed=0, checks=[], memory_peak_bytes=0,
                          facts={"batch": batch}, spans=spans)
    cell = harness.load_cell(CELL)
    share = reader.read(cell, out, "transformer_roofline.batched")
    assert share == pytest.approx(100 * reader.flops(cfg, batch)
                                  / (14e-3 * yardstick.PEAK_FLOPS["f32"]), rel=1e-12)
    # None where the span did not open, or off the card
    spans.device_ms = {"transformer": 15.0}
    assert reader.read(cell, out, "transformer_roofline.batched") is None
    spans.device_ms, spans.on_card = {reader.SPAN: 14.0}, False
    assert reader.read(cell, out, "transformer_roofline.batched") is None
