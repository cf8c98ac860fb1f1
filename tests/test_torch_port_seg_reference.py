"""The benchmark's segmentation kind (``benchmark/models/seg.py``,
``benchmark/reference/seg.py``) on the CPU at 64x128, patch 32, from the
benchmark's seeded weights (``benchmark/weights.py``), and the bounds the
benchmark counts for it.

- The port's f32 ``SphericalFusionSeg`` gives the plain reference's
  logits, and one ``train_step_sem`` its cross-entropy and first
  gradients, on labels some of which are ignored (-1).
- The kind refuses a merge in another type than f32.
- ``yardstick.kernel_bounds`` counts the merge as 14 f32 source rows and
  14 output rows a panorama (the one-shot model: 2 f16 and 2), and
  ``metrics/heads_roofline.py`` bounds the heads as PERF.md's table of
  kernels gives them at b64 bf16.
- The cell's check of the merge alone (``modes/serve_batched_merge.py``,
  ``merge_gap``) passes the port's f32 merge and fails the reference's
  merge of the same rows in f16 and in bf16; a run of the cell's mode is
  correct, and not correct where the port's blend is handed its source
  rounded to f16 or bf16, which the logits' check lets through.
"""

import time

import pytest
import torch

from benchmark import check, generator, harness, program, weights, yardstick
from benchmark.modes import serve_batched_merge as merge_mode
from benchmark.modes import train as train_mode
from benchmark.reference import model as ref
from benchmark.reference import seg
from benchmark.tests.small import overrides

CELL = "seg_s2d3d.batched_b64_f32merge"
ONESHOT = "oneshot_s2d3d.batched_b64"
F32 = {"trunk": "f32", "merge": "f32"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def _small(cell=CELL):
    return harness.load_cell(cell, overrides=overrides(cell))


@pytest.mark.parametrize("seed", [17, 2**40 + 3])
def test_the_port_gives_the_references_logits(seed):
    c = _small()
    cfg = c.config
    kind = program.kind(cfg)
    state = weights.make(cfg, generator.stream_seed(seed, generator.WEIGHTS), "cpu")
    model = kind.build(cfg, F32, state, "cpu").eval()
    rgb = generator.erp_pool(cfg, c.traffic, seed, "cpu")[0]
    with torch.inference_mode():
        (d,) = kind.outputs(model(rgb))
    (r,) = check.reference_outputs(cfg, state, ref.Geometry(cfg, "cpu"), rgb)
    assert d.shape == r.shape == (rgb.shape[0], *cfg["erp_size"], cfg["num_classes"])
    assert d.dtype == torch.float32
    assert max(check.rel_l2(d, r)) < 1e-4
    # logits that are not degenerate: classes apart at a pixel, and more
    # than one class the largest somewhere
    assert (r.amax(-1) - r.amin(-1)).mean() > 1e-2
    assert r.argmax(-1).unique().numel() > 1


def test_one_train_step_matches_the_references_loss_and_first_gradients():
    c = _small()
    cfg = c.config
    tr = harness.load_json(f"{harness.HERE}/traffic/train_b8.json")
    kind = program.kind(cfg)
    state = weights.make(cfg, 19, "cpu")
    ts = program.train_state(kind.build(cfg, F32, state, "cpu"), tr)
    pool = generator.train_pool(cfg, dict(tr, batch=2, pool=1), 4, "cpu")
    labels = pool[0]["labels"]
    assert (labels == seg.IGNORE).any() and (labels >= 0).any()
    assert labels.max() < cfg["num_classes"]
    prog = train_mode.first_steps(kind, ts, pool, 1, state, "cpu")
    refr = check.reference_train(cfg, tr["recipe"], state, pool, "cpu", steps=1)
    assert abs(prog["loss"][0] - refr["loss"][0]) <= 1e-5 * refr["loss"][0]
    gaps = check.train_gaps(prog, refr)
    assert gaps["loss_gap"] < 1e-3 and gaps["grad_gap"] < 1e-2
    assert set(prog["grad"]) == set(refr["grad"])


def test_the_reference_loss_ignores_minus_one_and_is_0_where_all_are():
    logits = torch.randn(1, 2, 3, 13)
    labels = torch.tensor([[[0, -1, 5], [12, -1, -1]]])
    kept = labels >= 0
    want = torch.nn.functional.cross_entropy(logits[kept], labels[kept])
    assert torch.allclose(seg.loss([logits], {"labels": labels}), want)
    assert seg.loss([logits], {"labels": torch.full_like(labels, -1)}).item() == 0.0


def test_the_kind_refuses_a_merge_other_than_f32():
    c = _small()
    with pytest.raises(ValueError, match="f32"):
        program.kind(c.config).build(c.config, {"trunk": "bf16", "merge": "f16"}, {}, "cpu")


def test_the_merge_bound_counts_14_f32_rows_against_the_one_shots_2_f16():
    seg_cfg, one = _small().config, _small(ONESHOT).config
    b = 3
    H, W = seg_cfg["erp_size"]
    h, w = seg_cfg["patch_size"]
    counts = yardstick.table_counts(seg_cfg)
    assert counts == yardstick.table_counts(one)  # the same tables
    e2p_src, e2p_quads = counts["e2p"]
    p2e_src, p2e_quads = counts["p2e"]

    def bound(n_bytes, n_ops):
        return max(n_bytes / 3.35e12, n_ops / 66.9e12)

    # e2p: 3 bf16 rows a panorama from and to the trunk's type
    e2p = bound(b * 3 * e2p_src * 2 + b * 3 * 18 * h * w * 2 + e2p_quads * 20,
                8 * e2p_quads * b * 3)
    merge = {rows: bound(b * rows * p2e_src * size + b * rows * H * W * 4 + p2e_quads * 20,
                         8 * p2e_quads * b * rows)
             for rows, size in ((14, 4), (2, 2))}
    got = {name: yardstick.kernel_bounds(cfg, {"trunk": "bf16", "merge": m}, b, False)
           for name, cfg, m in (("seg", seg_cfg, "f32"), ("oneshot", one, "f16"))}
    assert got["seg"]["quad_blend"] == pytest.approx(e2p + merge[14], rel=1e-12)
    assert got["oneshot"]["quad_blend"] == pytest.approx(e2p + merge[2], rel=1e-12)
    assert got["seg"]["up2x"] == got["oneshot"]["up2x"]  # the same trunk


@pytest.mark.parametrize("cell, ms", [(CELL, 0.518), (ONESHOT, 0.383)])
def test_the_heads_bound_at_b64_bf16(cell, ms):
    cfg = harness.load_cell(cell).config
    heads_roofline = harness.metric_reader("heads_roofline.batched")
    # the decoder's (1152, 32, 128, 128) map read and the 14 or 2 outputs
    # written in bf16, bound by the bytes
    assert round(1e3 * heads_roofline.bound_s(cfg, "bf16", 64), 3) == ms


@pytest.mark.parametrize("seed", [23, 2**35 + 11])
def test_the_merge_check_passes_the_f32_merge_and_fails_f16_and_bf16(seed):
    c = _small()
    cfg = c.config
    kind = program.kind(cfg)
    state = weights.make(cfg, generator.stream_seed(seed, generator.WEIGHTS), "cpu")
    model = kind.build(cfg, c.traffic["precision"], state, "cpu").eval()
    rgb = generator.erp_pool(cfg, c.traffic, seed, "cpu")[0]
    heads = []
    with torch.inference_mode():
        model.gather_heads = merge_mode.holding(model, heads)
        (served,) = kind.outputs(model(rgb))
        del model.gather_heads
    assert "gather_heads" not in vars(model) and len(heads) == 1
    pred, conf = heads[0]
    rows = rgb.shape[0] * cfg["n_patches"]
    assert pred.shape == (rows, cfg["num_classes"], *cfg["patch_size"])
    assert conf.shape == (rows, 1, *cfg["patch_size"])
    gaps = merge_mode.merge_gaps(cfg, [(pred, conf, served)], "cpu", 1, merge_mode.CONTROLS)
    limit = c.limits["limits"][merge_mode.CHECK]
    assert len(gaps["program"]) == rgb.shape[0] and max(gaps["program"]) < limit / 10
    for ctl in merge_mode.CONTROLS:
        assert min(gaps[repr(ctl)]) > 10 * limit


@pytest.mark.parametrize("source", ["f32", "f16", "bf16"])
def test_a_run_of_the_cell_fails_a_merge_below_f32(source, monkeypatch):
    from omnifusion_torch.models import segmentation

    if source != "f32":
        blend, dtype = segmentation.pers2equi_cf, getattr(torch, {"f16": "float16"}.get(
            source, "bfloat16"))
        monkeypatch.setattr(segmentation, "pers2equi_cf",
                            lambda src, p2e: blend(src.to(dtype).float(), p2e))
    c = _small()
    out = merge_mode.run(harness.Context(c, 2**33 + 9, 0.2, False, "cpu", time.perf_counter()))
    checks = {k.name: k for k in out.checks}
    assert set(checks) == {"logit_gap", merge_mode.CHECK}
    assert checks["logit_gap"].ok  # blind to the merge's type
    assert checks[merge_mode.CHECK].ok == (source == "f32")
    assert out.failed == (0 if source == "f32" else c.traffic["batch"])
