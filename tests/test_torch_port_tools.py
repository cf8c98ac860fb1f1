"""The port's measurement entry points run end to end on the CPU, at
64x128 ERP, patch 32, batch 1 (full-depth model, seeded weights), and print
what their users read: omnifusion_torch/bench.py and the four tools under
omnifusion_torch/tools/. On the card they time with CUDA events
(chip_smoke.py runs them at the flagship); here the times are the CPU's and
say so."""

import json

import pytest

from omnifusion_torch import bench
from omnifusion_torch.tools import bench_components, bench_kernels, bench_merge, profile_forward

SMALL = ["--device", "cpu", "--erp_size", "64,128", "--patchsize", "32", "--batch", "1"]


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_bench_prints_one_json_line(capsys):
    bench.main(SMALL + ["--iters", "2"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert {"metric", "value", "unit", "batch", "dtype", "merge_dtype", "gpu"} <= set(line)
    assert line["unit"] == "panoramas/sec" and line["value"] > 0 and line["batch"] == 1
    assert (line["dtype"], line["merge_dtype"]) == ("bf16", "f16")  # the headline recipe
    # a CPU run names no card and reports no device time
    assert line["gpu"] is None and line["device_ms"] is None and line["device"] == "cpu"
    assert line["forwards"] == 2 + 2  # the warm-up and the timed forwards


@pytest.mark.parametrize("bf16", [False, True])
def test_bench_components(capsys, bf16):
    argv = SMALL + ["--reps", "1", "--merge_dtype", "f16"] + (["--bf16"] if bf16 else [])
    bench_components.main(argv)
    lines = _json_lines(capsys.readouterr().out)
    assert [r["component"] for r in lines] == ["e2p", "merge", "trunk", "full"]
    for r in lines:
        assert r["ms"] > 0 and r["timed_on"] == "cpu host clock"
        assert r["dtype"] == ("bf16" if bf16 else "f32") and r["merge_dtype"] == "f16"
    bench_components.main(argv + ["--only", "merge"])
    assert [r["component"] for r in _json_lines(capsys.readouterr().out)] == ["merge"]


def test_bench_merge_checks(capsys):
    bench_merge.main(SMALL + ["--checks_only"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "probe ok on cpu"  # the probe runs first
    checks = _json_lines(out)
    assert [c["check"] for c in checks] == ["merge", "e2p"]
    assert checks[0]["shape"] == [64, 2, 18 * 32 * 32] and checks[1]["shape"] == [64, 64 * 128, 3]
    assert all(c["max_abs_err"] <= c["tol"] for c in checks)


@pytest.mark.parametrize("train", [False, True])
def test_profile_forward(capsys, train):
    argv = SMALL + ["--reps", "2", "--top", "5"] + (["--train"] if train else ["--bf16"])
    profile_forward.main(argv)
    out = capsys.readouterr().out
    assert "== host time by stage" in out and "== host self time by operator" in out
    result = _json_lines(out)[-1]
    assert result["what"] == ("train step" if train else "forward")
    assert result["runs"] == 2 + 1  # the traced reps and the warm-up
    stages = {s["name"] for s in result["host_stages"]}
    if train:
        assert stages == {"forward", "loss", "backward", "optimizer"}
    else:
        assert stages == {"e2p", "points", "encoder", "transformer", "decoder", "heads", "merge"}
    assert abs(sum(s["share"] for s in result["host_stages"]) - 1.0) < 1e-6
    assert len(result["top_ops"]) == 5 and all(r["ms_per_rep"] > 0 for r in result["top_ops"])


def test_bench_kernels(capsys):
    bench_kernels.main(SMALL[:-2] + ["--batch", "1", "--train_batch", "1", "--iters", "1",
                                     "--blend_batches", "1,3", "--e2p_q_batches", "2"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["gpu"] is None and line["timed_on"] == "cpu host clock"
    blend = line["quad_blend"]
    assert sorted(blend) == sorted(
        [f"{case}_b{b}" for case in ("merge_float16", "merge_float32", "e2p_bfloat16",
                                     "e2p_float32", "merge_n6_float16", "merge_n6_float32")
         for b in (1, 3)] + ["e2p_q_float32_b2"])
    assert blend["merge_float16_b3"]["shape"] == [3, 2, 18 * 32 * 32]
    assert blend["e2p_float32_b1"]["shape"] == [1, 64 * 128, 3]
    # the iterative model's feedback: a 1-channel depth into patches of 8
    assert blend["e2p_q_float32_b2"]["shape"] == [2, 64 * 128, 1]
    assert line["quad_spread"]["e2p_q"]["shape"] == [1, 18 * 8 * 8, 1]
    assert line["quad_spread"]["e2p_q"]["ms"] > 0
    for r in blend.values():
        assert r["ms"] > 0 and r["bound_ms"] > 0 and "library_ms" not in r  # no card, no library
    assert all(r["equi2pers_ms"] > 0 for k, r in blend.items() if k.startswith("e2p"))
    assert line["quad_spread"]["shape"] == [1, 2, 64 * 128] and line["quad_spread"]["ms"] > 0
    for recipe, dtypes in (("f32", ["float32"] * 5), ("bf16", ["float32"] + ["bfloat16"] * 4)):
        rows = line["up2x"][recipe]["shapes"]
        assert [r["dtype"] for r in rows] == dtypes
        # patch 32: sides 1, 2, 4, 8, 16 (the flagship's 4 ... 64)
        assert [r["shape"][2] for r in rows] == [1, 2, 4, 8, 16]
        assert line["up2x"][recipe]["ms"] == pytest.approx(sum(r["ms"] for r in rows))
        # the train step's adjoints: cotangents of the outputs' size
        adj = line["up2x_adjoint"][recipe]["shapes"]
        assert [r["dtype"] for r in adj] == dtypes
        assert [r["shape"] for r in adj] == [[18, c, 2 * s, 2 * s] for c, s in zip(
            (512, 128, 64, 64, 32), (1, 2, 4, 8, 16))]
        assert all(r["ms"] > 0 and r["bound_ms"] > 0 for r in adj)
        assert line["up2x_adjoint"][recipe]["ms"] == pytest.approx(sum(r["ms"] for r in adj))


def test_throughput_counts_items_per_second(monkeypatch):
    from omnifusion_torch.utils import profiling

    clock = iter([10.0, 10.5, 11.0, 11.5])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    meter = profiling.Throughput(window=3)
    assert meter.per_sec == 0.0
    for n in (4, 8, 8, 8):
        meter.update(n)
    # the window keeps the last 3 stamps (10.5, 11.0, 11.5): 16 items in 1 s
    assert meter.per_sec == 16.0


def test_blend_matrix_is_the_blend():
    """The library yardstick (torch.sparse.mm on utils.profiling.blend_matrix)
    computes the blend, tail included, and blend_bound counts its bytes:
    the source pixels it reads, not the whole source."""
    import torch

    from omnifusion_torch.ops.quad_blend import quad_blend_plain
    from omnifusion_torch.projection import ProjectionSpec
    from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
    from omnifusion_torch.utils.profiling import (
        HBM_BYTES_PER_S, blend_bound, blend_matrix, source_pixels,
    )

    tables = pers2equi_tables(ProjectionSpec.create((64, 128), (32, 32), (80, 80), 4), "cpu")
    assert tables.n_tail > 0
    src = torch.rand(3, 2, tables.n_in, generator=torch.Generator().manual_seed(0))
    want = quad_blend_plain(src, tables)
    got = torch.sparse.mm(blend_matrix(tables), src.permute(2, 0, 1).reshape(tables.n_in, -1))
    torch.testing.assert_close(got.reshape(tables.n_out, 3, 2).permute(1, 2, 0), want,
                               rtol=0, atol=2e-6)
    def read(t):  # the source pixels that a corner with weight reads
        offs = torch.tensor([0, 1, t.row_stride, t.row_stride + 1])
        pix = set(((t.idx.long()[..., None] + offs) % t.n_in)[t.w4 != 0].tolist())
        if t.n_tail:
            pix |= set(((t.tail_idx.long()[:, None] + offs) % t.n_in)[t.tail_w != 0].tolist())
        return len(pix)

    ms, by = blend_bound(src, tables, want)
    t = tables
    assert source_pixels(t) == read(t) > 0.95 * t.n_in
    n_bytes = 3 * 2 * read(t) * 4 + sum(x.numel() * x.element_size() for x in (
        want, t.idx, t.w4, t.tail_ptr, t.tail_idx, t.tail_w))
    assert by == "bytes" and ms == n_bytes / HBM_BYTES_PER_S * 1e3
    # the iterative model's quarter-resolution equi2pers reads a small part
    # of its source
    spec = ProjectionSpec.create((64, 128), (32, 32), (80, 80), 4).with_patch_scale(4)
    t = equi2pers_tables(spec, "cpu")
    assert source_pixels(t) == read(t) < t.n_in / 2
    depth = torch.rand(2, t.n_in, 1, generator=torch.Generator().manual_seed(1))
    out = quad_blend_plain(depth, t, channel_last=True)
    n_bytes = 2 * read(t) * 4 + sum(x.numel() * x.element_size() for x in (out, t.idx, t.w4))
    assert blend_bound(depth, t, out) == (n_bytes / HBM_BYTES_PER_S * 1e3, "bytes")


def test_blend_variants_patch_the_kernel_as_it_stands():
    # each copy takes out one part of csrc/quad_blend.cu by a text patch, so
    # each patched text occurs there once; the tool needs the card
    from omnifusion_torch.ops import _build
    from omnifusion_torch.tools import blend_variants

    with open(f"{_build.CSRC}/quad_blend.cu") as f:
        text = f.read()
    assert [text.count(old) for _, old, _ in blend_variants.PATCHES] == [1] * 3
    assert blend_variants.build_parser().parse_args([]).batches == "64,256"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blend_variants.main([])


def test_adjoint_variants_patch_the_kernel_as_it_stands(tmp_path):
    # each copy rebuilds csrc/up2x.cu's adjoint another way by text patches,
    # so each patched text occurs there once; the tool needs the card
    from omnifusion_torch.tools import adjoint_variants

    other = tmp_path / "up2x.cu"
    other.write_text("// another version")
    texts = adjoint_variants._sources([f"parent={other}"])
    assert list(texts) == [name for name, _ in adjoint_variants.PATCHES] + ["parent"]
    assert texts["parent"] == "// another version"
    assert "constexpr int kAdjCols = 1;" in texts["one_output"]
    assert "constexpr int kAdjRows = 2;" in texts["rows2"]
    assert "t / col_groups.d" in texts["one_output_divide"]
    assert "kAdjVector = false" in texts["scalar_loads"]
    for bad in ("no_path", "=x", "one_output=x", "kernel=x"):
        with pytest.raises(ValueError, match="name=path"):
            adjoint_variants._sources([bad])
    args = adjoint_variants.build_parser().parse_args(["--source", "a=b", "--source", "c=d"])
    assert (args.batch, args.source, args.iters) == (8, ["a=b", "c=d"], 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adjoint_variants.main([])
