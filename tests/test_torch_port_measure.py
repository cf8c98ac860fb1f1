"""The port's measurement tools on the CPU, held against the JAX package:
FLOPs counted from shapes (utils.profiling.count_flops), sol_model's
accounting, bench_train, bench_sweep, eval_merge_dtype and verify_kernels.

- The port's forward FLOPs equal the JAX model's, both counted from shapes:
  every conv_general_dilated and dot_general of the JAX forward's jaxpr
  (resize_impl="pallas", kernel_impl="pallas": the upsamples are Pallas
  calls, as the port's are kernels). The convolutions agree exactly. The
  matmuls are the transformer's on both sides and agree exactly too; the
  JAX forward's other dot_generals are its XLA blend path's (below 128
  source rows the "pallas" blends fall back to it), blend work that the
  port's count leaves out as it leaves out its blend kernels.
- sol_model records the JAX account's conv and upsample shapes (NCHW
  against NHWC), and its kernel rows are utils.profiling's bounds on the
  same tables.
- The tools print their lines and one JSON line at 64x128, and bench_train
  reports an out-of-memory run in one line and exits 0.
- eval_merge_dtype.evaluate on converted JAX weights gives the JAX
  make_eval_step's metrics.
- verify_kernels refuses to run without a card.
"""

import json
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

import omnifusion_tpu.models.spherical_fusion as jsf
from omnifusion_tpu.data import make_dataset as jax_make_dataset
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.models.transformer import TransformerCascade as JaxTransformer
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.training import make_eval_step
from omnifusion_torch.models import SphericalFusion, init_weights, state_dict_from_jax
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.tools import bench_sweep, bench_train, eval_merge_dtype, sol_model
from omnifusion_torch.utils.profiling import (
    PEAK_FLOPS, blend_work, count_flops, mfu, spread_work, up2x_adjoint_work, up2x_work,
)

ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
SIZES = [((128, 256), 64), ((64, 128), 32)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _jaxpr_ops(jaxpr, out: dict) -> dict:
    """Every conv_general_dilated and dot_general of ``jaxpr`` and its
    sub-jaxprs (not inside a Pallas kernel), with 2 |out| kh kw cin and
    2 |out| K FLOPs."""
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "pallas_call":
            continue
        if name == "conv_general_dilated":
            lhs, rhs = (v.aval for v in eqn.invars)
            o = eqn.outvars[0].aval
            rs = eqn.params["dimension_numbers"].rhs_spec  # (out, in, spatial...)
            out["convs"].append({"lhs": lhs.shape, "rhs": rhs.shape, "out": o.shape,
                                 "dtype": lhs.dtype,
                                 "flops": 2 * math.prod(o.shape) * math.prod(
                                     rhs.shape[d] for d in rs[1:])})
        elif name == "dot_general":
            a = eqn.invars[0].aval
            (ca, _), _ = eqn.params["dimension_numbers"]
            out["dots"].append(2 * math.prod(eqn.outvars[0].aval.shape)
                               * math.prod(a.shape[d] for d in ca))
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _jaxpr_ops(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _jaxpr_ops(sub, out)
    return out


def _jax_forward_ops(erp, patch, **kw) -> dict:
    model = JaxSphericalFusion(spec=JaxSpec.create(erp, (patch, patch), (80, 80), 4),
                               kernel_impl="pallas", resize_impl="pallas", **kw)
    rgb = jax.ShapeDtypeStruct((1, *erp, 3), jnp.float32)
    v = jax.eval_shape(lambda r: model.init(jax.random.PRNGKey(0), r), rgb)
    jx = jax.make_jaxpr(lambda v, r: model.apply(v, r, train=False))(v, rgb)
    return _jaxpr_ops(jx.jaxpr, {"convs": [], "dots": []})


def _jax_transformer_flops(emb: int, p: int) -> int:
    t = JaxTransformer(emb, p, depth=6, num_heads=4)
    tok = jax.ShapeDtypeStruct((1, p, emb), jnp.float32)
    v = jax.eval_shape(lambda x: t.init(jax.random.PRNGKey(0), x), tok)
    return sum(_jaxpr_ops(jax.make_jaxpr(t.apply)(v, tok).jaxpr, {"convs": [], "dots": []})["dots"])


@pytest.mark.parametrize("erp,patch", SIZES)
def test_forward_flops_equal_the_jax_models(erp, patch):
    jops = _jax_forward_ops(erp, patch)
    spec = ProjectionSpec.create(erp, patch, (80, 80), 4)
    model = init_weights(SphericalFusion(spec, device="cpu"), 0).eval()
    x = torch.rand(1, *erp, 3)
    with torch.no_grad():
        ours = count_flops(lambda: model(x))
    convs = ours["by_op"].pop("aten.convolution")
    assert len(jops["convs"]) == 50  # 49 at patch 128, where no up_proj is needed
    assert convs == sum(c["flops"] for c in jops["convs"])
    assert set(ours["by_op"]) <= {"aten.mm", "aten.addmm", "aten.bmm"}
    # the transformer's matmuls: equal (tolerance 0)
    emb = 32 * (-(-patch // 32)) ** 2
    assert sum(ours["by_op"].values()) == _jax_transformer_flops(emb, spec.n_patches)
    assert ours["total"] == convs + sum(ours["by_op"].values())


def test_step_flops_count_the_backward_and_grow_with_the_batch():
    # forward + backward: every convolution's backward computes the weight
    # gradient, and all but the first (whose input takes no gradient) the
    # data gradient too; the geometric embedding runs once per batch, so
    # the count grows by the rest of the model per panorama
    from torch.utils.flop_counter import FlopCounterMode

    from omnifusion_torch.training import forward_loss

    spec = ProjectionSpec.create((64, 128), 32, (80, 80), 4)
    model = init_weights(SphericalFusion(spec, depth=1, encoder_stages=ONE_BLOCK, device="cpu"), 0)
    rng = np.random.default_rng(0)

    def step(b):
        batch = {"rgb": torch.from_numpy(rng.random((b, 64, 128, 3), dtype=np.float32)),
                 "depth": torch.ones(b, 64, 128, 1) * 2, "mask": torch.ones(b, 64, 128, 1)}
        mode = FlopCounterMode(display=False)
        with mode:
            forward_loss(model, batch)[0].backward()
        counts = mode.get_flop_counts()
        embedding = sum(sum(c.values()) for k, c in counts.items() if k.endswith(".mlp_points"))
        ours = count_flops(lambda: forward_loss(model, batch)[0].backward())
        assert ours["total"] == mode.get_total_flops()
        return ours, embedding

    (one, emb1), (two, emb2) = step(1), step(2)
    with torch.no_grad():
        fwd = count_flops(lambda: model.eval()(torch.rand(1, 64, 128, 3)))
    conv = fwd["by_op"]["aten.convolution"]
    assert one["by_op"]["aten.convolution"] == conv
    assert conv < one["by_op"]["aten.convolution_backward"] < 2 * conv
    assert emb1 == emb2 > 0
    assert two["total"] - one["total"] == one["total"] - emb1


def test_mfu_is_flops_over_time_against_the_peak():
    assert PEAK_FLOPS == {"f32": 66.9e12, "tf32": 494.7e12, "bf16": 989.4e12}
    assert mfu(PEAK_FLOPS["bf16"] * 1e-3, 1.0, "bf16") == pytest.approx(1.0)
    assert mfu(66.9e9, 2.0, "f32") == pytest.approx(0.5)


def _jax_account_shapes(erp, patch) -> tuple[list, list]:
    """The JAX sol_model's capture (tools/sol_model.py: account) at a small
    size: the resizes through a wrapped spherical_fusion.resize_bilinear and
    the convolutions through a wrapped lax.conv_general_dilated, under
    jax.eval_shape, the bf16 recipe at batch 2."""
    resizes, convs = [], []
    orig_resize, orig_conv = jsf.resize_bilinear, jax.lax.conv_general_dilated

    def rec_resize(x, size, impl="xla"):
        out = orig_resize(x, size, impl="xla")
        resizes.append((tuple(x.shape), tuple(out.shape), x.dtype))
        return out

    def rec_conv(lhs, rhs, *a, **kw):
        out = orig_conv(lhs, rhs, *a, **kw)
        convs.append((tuple(lhs.shape), tuple(rhs.shape), tuple(out.shape), lhs.dtype))
        return out

    jsf.resize_bilinear, jax.lax.conv_general_dilated = rec_resize, rec_conv
    try:
        model = jsf.SphericalFusion(spec=JaxSpec.create(erp, (patch, patch), (80, 80), 4),
                                    dtype=jnp.bfloat16, merge_dtype=jnp.float16)
        rgb = jax.ShapeDtypeStruct((2, *erp, 3), jnp.float32)
        v = jax.eval_shape(lambda r: model.init(jax.random.PRNGKey(0), r), rgb)
        resizes.clear()
        convs.clear()
        jax.eval_shape(lambda v, r: model.apply(v, r, train=False), v, rgb)
    finally:
        jsf.resize_bilinear, jax.lax.conv_general_dilated = orig_resize, orig_conv
    return resizes, convs


@pytest.fixture(scope="module")
def sol():
    args = sol_model.build_parser().parse_args(
        ["--device", "cpu", "--erp_size", "64,128", "--patchsize", "32", "--batch", "2",
         "--train"])
    return args, sol_model.run(args)


def test_sol_model_records_the_jax_accounts_shapes(sol):
    _, out = sol
    resizes, convs = _jax_account_shapes((64, 128), 32)

    def nhwc(s):
        return (s[0], s[2], s[3], s[1])

    # the upsamples: what each decoder conv reads is the upsample's output
    assert [(nhwc(r["output"]), r["dtype"]) for r in out["resize_shapes"]] == [
        (o, str(dt)) for _, o, dt in resizes]
    assert len(resizes) == 5
    ours = sorted((nhwc(c["input"]), (c["weight"][2], c["weight"][3], c["weight"][1],
                                      c["weight"][0]), nhwc(c["output"]), c["dtype"])
                  for c in out["conv_shapes"])
    theirs = sorted((lhs, rhs, o, str(dt)) for lhs, rhs, o, dt in convs)
    assert ours == theirs and len(ours) == out["convs"] == 50


def test_sol_model_rows_are_the_kernels_bounds(sol):
    args, out = sol
    spec = ProjectionSpec.create((64, 128), 32, (80, 80), 4)
    t_e2p, t_p2e = equi2pers_tables(spec, "cpu"), pers2equi_tables(spec, "cpu")
    n_erp, n_pp = 64 * 128, spec.n_patches * 32 * 32
    rows = {r["stage"]: r for r in out["rows"] + out["train_rows"]}
    # the real tensors of each call, as chip_smoke.py's time rows pass them
    x = torch.rand(2, n_erp, 3).bfloat16()
    want = blend_work(x, t_e2p, torch.empty(2, n_pp, 3, dtype=torch.bfloat16))
    assert (rows["equi2pers"]["bytes"], rows["equi2pers"]["operations"]) == want
    x = torch.rand(2, 2, n_pp).half()
    assert (rows["merge"]["bytes"], rows["merge"]["operations"]) == blend_work(
        x, t_p2e, torch.empty(2, 2, n_erp))
    cot = torch.rand(2, 2, n_erp)
    assert (rows["merge spread"]["bytes"], rows["merge spread"]["operations"]) == spread_work(
        cot, t_p2e.vjp, torch.empty(2, 2, n_pp))
    ups = [r for r in out["rows"] if r["kernel"] == "up2x"]
    adj = [r for r in out["train_rows"] if r["kernel"] == "up2x_adjoint"]
    assert len(ups) == len(adj) == 5
    for r, a, rs in zip(ups, adj, out["resize_shapes"]):
        n, c, h, w = rs["output"]
        src = torch.empty(n, c, h // 2, w // 2, dtype=getattr(torch, rs["dtype"]))
        assert (r["bytes"], r["operations"]) == up2x_work(src)
        assert (a["bytes"], a["operations"]) == up2x_adjoint_work(src)
    # the floors: sums of their stages at the datasheet's rates
    assert out["forward_floor_ms"] == pytest.approx(
        out["conv_floor_ms"] + out["matmul_floor_ms"] + sum(r["floor_ms"] for r in out["rows"]))
    assert out["train_bound_ms"] > 3 * out["conv_floor_ms"] and out["optimizer_ms"] > 0
    assert out["flops_t"] * 1e12 == pytest.approx(
        out["conv_flops_t"] * 1e12 + out["matmul_flops_t"] * 1e12)
    assert out["gpu"] is None and out["calibration"] is None


def test_sol_model_prints_its_table_and_a_json_line(capsys):
    sol_model.main(["--device", "cpu", "--erp_size", "64,128", "--patchsize", "32", "--batch",
                    "1", "--model", "iterative"])
    lines = capsys.readouterr().out.splitlines()
    out = json.loads(lines[-1])
    assert {"flops_t", "conv_floor_ms", "forward_floor_ms", "train_bound_ms", "model"} <= set(out)
    assert out["model"] == "iterative" and out["train_bound_ms"] is None
    assert [r["calls"] for r in out["rows"] if r["kernel"] == "quad_blend"] == [1, 2, 1]
    assert any(line.startswith("forward floor:") for line in lines)


def test_sol_model_calibrate_needs_the_card():
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        sol_model.main(["--device", "cpu", "--calibrate"])


SMALL_TRAIN = ["--device", "cpu", "--erp", "64,128", "--patch", "32,32", "--iters", "1",
               "--batch", "2"]


def test_bench_train_prints_its_lines_and_a_json_line(capsys):
    bench_train.main(SMALL_TRAIN)
    lines = capsys.readouterr().out.splitlines()
    out = json.loads(lines[-1])
    assert lines[1].startswith("forward  b=2:") and lines[2].startswith("train    b=2:")
    assert out["oom"] is None and out["gpu"] is None and out["device"] == "cpu"
    for key in ("forward", "train"):
        r = out[key]
        # a CPU run reports no device time and no MFU
        assert r["device_ms"] is None and r["mfu"] is None and r["wall_ms"] > 0
        assert r["gflop"] > 0
    assert out["train"]["gflop"] > 2 * out["forward"]["gflop"]
    assert np.isfinite(out["train"]["loss"])


def test_bench_train_remat_counts_the_model_flops_and_the_recompute(capsys):
    bench_train.main(SMALL_TRAIN + ["--remat", "--skip_fwd"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    plain = bench_train.run(bench_train.build_parser().parse_args(SMALL_TRAIN + ["--skip_fwd"]))
    assert out["forward"] is None and out["remat"]
    assert out["train"]["gflop"] == plain["train"]["gflop"]
    assert out["train"]["gflop_executed"] > out["train"]["gflop"]


def test_bench_train_reports_out_of_memory_in_one_line(capsys, monkeypatch):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of "
            "79.19 GiB of which 1.02 GiB is free.")

    monkeypatch.setattr(bench_train, "create_train_state", oom)
    assert bench_train.main(SMALL_TRAIN + ["--skip_fwd"]) is None  # exit code 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == ("OOM needed=2.00GiB limit=79.19GiB batch=2 model=oneshot remat=False "
                        "bf16=False merge=f32 erp=64x128 phase=train")
    assert json.loads(lines[-1])["oom"] == lines[1]


def test_bench_sweep_prints_its_lines_and_a_json_line(capsys):
    bench_sweep.main(["--device", "cpu", "--erp_size", "64,128", "--patchsize", "32",
                      "--batches", "1,2", "--modes", "f32,f16_merge", "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    out = json.loads(lines[-1])
    assert [(r["batch"], r["mode"]) for r in out["rows"]] == [
        (1, "f32"), (1, "f16_merge"), (2, "f32"), (2, "f16_merge")]
    assert lines[0].startswith("b=  1 f32")
    for r in out["rows"]:
        assert r["device_ms"] is None and r["mfu"] is None and r["panos_per_s"] > 0
    # the one-shot model's FLOPs: the embedding once, the rest per panorama
    g = {(r["batch"], r["mode"]): r["gflop"] for r in out["rows"]}
    assert g[1, "f32"] == g[1, "f16_merge"] and 1.9 * g[1, "f32"] < g[2, "f32"] < 2 * g[1, "f32"]


@pytest.fixture(scope="module")
def converted():
    """JAX init at 64x128/p32 (one-block stages, depth 1), carried across,
    with the BatchNorms' running statistics moved off (0, 1)."""
    kw = dict(spec=JaxSpec.create((64, 128), (32, 32), (80, 80), 4), depth=1,
              encoder_stages=ONE_BLOCK)
    v = jax.tree_util.tree_map(np.array, jax.jit(JaxSphericalFusion(**kw).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 64, 128, 3))))
    v["params"]["trunk"]["pred"]["kernel"] *= 0.05
    v["params"]["trunk"]["pred"]["bias"] += 2.0
    rng = np.random.default_rng(1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.random(a.shape) * 0.1).astype(np.float32), v["batch_stats"])
    return kw, v


def _jax_eval(kw, v, merge_dtype) -> dict:
    model = JaxSphericalFusion(**kw, merge_dtype=merge_dtype)
    step = make_eval_step(model)
    ds = jax_make_dataset("synthetic", size=4, pano_h=64, pano_w=128, seed=0)
    totals, total_n = {}, 0.0
    for i in (0, 2):
        rgb, depth, mask = (np.stack(c) for c in zip(ds[i], ds[i + 1]))
        m, n, _ = step(v["params"], v["batch_stats"],
                       {"rgb": jnp.asarray(rgb), "depth": jnp.asarray(depth),
                        "mask": jnp.asarray(mask)})
        for k, x in m.items():
            totals[k] = totals.get(k, 0.0) + float(x) * float(n)
        total_n += float(n)
    return {k: x / total_n for k, x in totals.items()}


def _gaps(a: dict, b: dict) -> dict:
    return {k: abs(a[k] - b[k]) / max(1.0, abs(b[k])) for k in b}


def test_evaluate_matches_the_jax_eval_step(converted):
    kw, v = converted
    sd = state_dict_from_jax(v)
    small = dict(patch=(32, 32), depth=1, encoder_stages=ONE_BLOCK, dtype=None)
    ours32, pred32 = eval_merge_dtype.evaluate(sd, (64, 128), None, "cpu", **small)
    ours16, pred16 = eval_merge_dtype.evaluate(sd, (64, 128), torch.float16, "cpu", **small)
    theirs32, theirs16 = _jax_eval(kw, v, None), _jax_eval(kw, v, jnp.float16)
    assert len(ours32) == 7 and pred32.shape == (4, 64, 128, 1)
    assert max(_gaps(ours32, theirs32).values()) < 1e-4, (ours32, theirs32)
    # the f16 merge: no farther from the JAX f16 merge than that is from the
    # JAX f32 merge (with the f32 bound as a floor, where the two agree)
    own = _gaps(theirs16, theirs32)
    for k, gap in _gaps(ours16, theirs16).items():
        assert gap <= max(own[k], 1e-4), (k, gap, own[k])
    assert not np.array_equal(pred16, pred32)  # the merge did run in f16


def test_eval_merge_dtype_reports_each_merge(capsys):
    eval_merge_dtype.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--train_size",
                           "2", "--train_erp", "64,128", "--eval_erps", "64,128",
                           "--patch", "32"])
    lines = capsys.readouterr().out.splitlines()
    out = json.loads(lines[-1])
    r = out["report"]["64x128"]
    assert set(r["f32_merge"]) == set(r["f16_merge_delta"]) and len(r["f32_merge"]) == 7
    assert set(r["bf16_merge_pred_rel_err"]) == {"mean", "p99", "max"}
    assert r["f16_abs_rel_delta_vs_bar"]["bar"] == 1e-3
    assert lines[0] == "train step 0: loss " + lines[0].split()[-1]


def test_verify_kernels_refuses_without_a_card():
    # the port's kernels run only on the card; the CPU suite holds their
    # plain versions against the JAX package
    proc = subprocess.run([sys.executable, "-m", "omnifusion_torch.tools.verify_kernels"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
