"""The port's mesh model axis on the CPU: gloo ranks on a (data, model) mesh
against one process and against the JAX data x model mesh.

One module fixture spawns four ranks once on the mesh data 2 x model 2
(omnifusion_torch.parallel.launch), which run
tests/torch_parallel_ranks.py: run_model_axis in sequence, then form data 1
x model 4 and data 1 x model 2 on the same processes; meanwhile this process
computes the references: the same steps in one process, the JAX train step
on make_mesh(2, 2), and cli.infer with --mesh 1,2 (two more ranks, spawned
by the entry point) and without a mesh.

- (a) the one-shot train step at global batch 2 on data 2 x model 2 against
  the JAX step on make_mesh(n_data=2, n_model=2) in f32, at the bounds of
  tests/test_torch_port_train.py::test_train_step_matches_jax, and against
  the port's one-process step in float64;
- (b) the iterative and segmentation steps on that mesh against one
  process, float64;
- (c) unequal chunks: data 1 x model 4 at batch 1 (18 patches: 5, 5, 4, 4
  rows) against one process, float64;
- (d) a batch that the data axis does not divide (3 on data 2): the
  segmentation step against one process, float64; its global BatchNorms
  reduce over the model group alone;
- (e) cli.test and cli.train (one step and a validation) with --mesh 2,2
  against the runs without a mesh; cli.infer with --mesh 1,2 writes each
  output once, equal to one process;
- (f) --remat on data 1 x model 2 against the plain step there;
- (g) both gathers' gradients by torch.autograd.gradcheck, float64, on the
  ranks of both meshes;
- the loader: on data 2 x model 2, the model ranks of a data group hold
  the same augmented batches of a Stanford2D3D-format split loaded by
  worker threads, though each rank's dataset draws its own augmentations.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as R
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.parallel import batch_sharding, make_mesh
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.training.trainer import _forward_loss
from omnifusion_torch import parallel
from omnifusion_torch.cli import common
from omnifusion_torch.cli import infer as infer_cli
from omnifusion_torch.models import init_weights, state_dict_from_jax
from omnifusion_torch.parallel import model_axis as ma
from omnifusion_torch.parallel.launch import spawn

SPAWN_TIMEOUT_S = 300
RANKS = R.MODEL_MESH.data * R.MODEL_MESH.model


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _tame(sd: dict) -> dict:
    # keeps the ReLU depth and the sigmoid confidence in their live range
    # under random weights (tests/test_torch_port_train.py)
    sd = dict(sd)
    for head in ("pred", "weight_pred"):
        sd[f"{head}.weight"] = sd[f"{head}.weight"] * 0.05
    sd["pred.bias"] = sd["pred.bias"] + 2.0
    return sd


def _jax_mesh_step() -> tuple[dict, dict]:
    """The JAX one-shot model's init (heads tamed) and its train step on
    make_mesh(n_data=2, n_model=2), the batch sharded over the data axis and
    the patch stack over both (spherical_fusion.py:104-107)."""
    kw = dict(spec=JaxSpec.create(R.ERP, R.PATCH, (80, 80), 4), depth=1,
              encoder_stages=R.ONE_BLOCK)
    batch = R.depth_batch(0)
    v = jax.tree_util.tree_map(np.array, jax.jit(JaxSphericalFusion(**kw).init)(
        jax.random.PRNGKey(3), jnp.asarray(batch["rgb"][:1])))
    v["params"]["trunk"]["pred"]["kernel"] *= 0.05
    v["params"]["trunk"]["weight_pred"]["kernel"] *= 0.05
    v["params"]["trunk"]["pred"]["bias"] += 2.0
    model = JaxSphericalFusion(**kw, kernel_impl="pallas_full")
    mesh = make_mesh(n_data=R.MODEL_MESH.data, n_model=R.MODEL_MESH.model,
                     devices=jax.devices()[:RANKS])
    with jax.set_mesh(mesh):
        jb = jax.device_put({k: jnp.asarray(x) for k, x in batch.items()}, batch_sharding(mesh))

        @jax.jit
        def run(params, stats):
            (loss, (new_stats, _)), grads = jax.value_and_grad(
                lambda p: _forward_loss(model, p, stats, jb, True), has_aux=True)(params)
            return dict(loss=loss, grads=grads, new_stats=new_stats,
                        grad_norm=optax.global_norm(grads))

        out = jax.tree_util.tree_map(np.asarray, run(v["params"], v["batch_stats"]))
    grads = state_dict_from_jax({"params": out["grads"], "batch_stats": out["new_stats"]})
    stats = state_dict_from_jax({"params": v["params"], "batch_stats": out["new_stats"]})
    return v, {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
               "grads": grads, "stats": stats}


def _infer(tmp, mesh: str) -> dict:
    """cli.infer over 3 panoramas at batch 2 with ``--mesh``: the written
    paths and the depth they hold."""
    base = ["--input", str(tmp / "in"), "--device", "cpu", "--erp_size", "64,128",
            "--patchsize", "32", "--batch", "2", "--seed", "0"]
    paths = infer_cli.run_infer(infer_cli.build_parser().parse_args(
        base + ["--mesh", mesh, "--save_path", str(tmp / f"out_{mesh}")]))
    return {"paths": [p.split(f"out_{mesh}")[1] for p in paths],
            "depth": [np.load(p) for p in paths]}


def _unaugmented_depth_sums(root: str, split: str) -> list[list[float]]:
    """Each global batch's depth sums per sample, in one process without
    augmentation (a flip and a roll keep a sample's sum)."""
    c = R.MODEL_AXIS_LOADER
    loader = R.DataLoader(R.SmallStanford(root, split), c["batch"], shuffle=True,
                          num_workers=1, seed=3)
    return [b["depth"].astype(np.float64).sum(axis=(1, 2, 3)).tolist()
            for _ in range(c["epochs"]) for b in loader]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (rank order) and this process's references."""
    work = tmp_path_factory.mktemp("model_axis")
    v, jax_mesh = _jax_mesh_step()
    init = {"oneshot": state_dict_from_jax(v),
            "iterative": _tame(init_weights(R.build("iterative"), 5).state_dict()),
            "seg": init_weights(R.build("seg"), 6).state_dict()}
    torch.save(init, work / "init.pt")
    # cli.test's weights: the seeded full-depth model, heads tamed
    model = init_weights(common.build_model(R.cli_args([]), device="cpu"), 0)
    torch.save(_tame(model.state_dict()), work / "tamed.pt")
    rng = np.random.default_rng(0)
    (work / "in").mkdir()
    for i in range(3):
        np.save(work / "in" / f"p{i}.npy", rng.random((*R.ERP, 3), dtype=np.float32))
    split = R.write_stanford_split(str(work), R.MODEL_AXIS_LOADER["n"])

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.run_model_axis, RANKS, (str(work),), lambda r: "cpu",
                            "gloo", SPAWN_TIMEOUT_S, R.MODEL_MESH)
        b2 = R.depth_batch(0)
        ref = {
            "jax_mesh": jax_mesh,
            "oneshot_f64": R.step("oneshot", init["oneshot"], b2),
            "iterative_f64": R.step("iterative", init["iterative"], b2, confidence=False),
            "seg_f64": R.step("seg", init["seg"], R.seg_batch(1)),
            "seg_whole": R.step("seg", init["seg"], R.seg_batch(1, b=3)),
            "unequal": R.step("oneshot", init["oneshot"], R.depth_batch(0, b=1)),
            "eval": R.model_axis_eval(str(work), "eval_ref"),
            "train": R.model_axis_train(str(work), "train_ref"),
            "infer": {m: _infer(work, m) for m in ("none", "1,2")},
            "loader_depth_sums": _unaugmented_depth_sums(str(work), split),
        }
        ranks = ranks.result()
    return ranks, ref


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def _held_to_one_process(got: dict, want: dict, what: str, stats_tol: float = 1e-8) -> None:
    """The float64 bounds of tests/test_torch_port_parallel.py's
    test_step_on_two_ranks_matches_one_process_f64."""
    assert "GlobalBatchNorm2d" in got["global_norms"]
    if what == "loss":
        assert abs(got["loss"] / want["loss"] - 1) < 1e-10
        assert abs(got["grad_norm"] / want["grad_norm"] - 1) < 1e-8
    elif what == "grads":
        assert set(got["grads"]) == set(want["grads"])
        rels = {n: _rel(g, want["grads"][n]) for n, g in got["grads"].items()
                if want["grads"][n].norm() > 0}
        assert max(rels.values()) < 1e-8, sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    else:
        keys = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
        if what == "params":
            keys = [k for k in want["state"] if k in want["grads"]]
        assert keys
        for k in keys:
            err = float((got["state"][k] - want["state"][k]).abs().max())
            assert err < stats_tol, (k, err)


def test_ranks_sit_on_the_mesh_as_jax_make_mesh_orders_devices(runs):
    # rank = d * MODEL + m, the device order of jax.make_mesh((D, M))
    for rank, r in enumerate(runs[0]):
        assert r["rank"] == rank and r["mesh"] == {"data": 2, "model": 2}
        assert (r["data_rank"], r["model_rank"]) == divmod(rank, R.MODEL_MESH.model)
    want = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:RANKS]).devices
    assert [[d.id for d in row] for row in want] == [[0, 1], [2, 3]]


# ---- (a), (b) ----


@pytest.mark.parametrize("kind", ["oneshot", "iterative", "seg"])
@pytest.mark.parametrize("what", ["loss", "grads", "stats", "params"])
def test_step_on_data_2_model_2_matches_one_process_f64(runs, kind, what):
    ranks, ref = runs
    for r in ranks:
        _held_to_one_process(r[f"{kind}_f64"], ref[f"{kind}_f64"], what)
    assert ref[f"{kind}_f64"]["global_norms"] == ["BatchNorm2d"]


@pytest.mark.parametrize("what", ["loss", "grads", "bn_stats"])
def test_oneshot_step_on_data_2_model_2_matches_jax_mesh(runs, what):
    want = runs[1]["jax_mesh"]
    for got in (r["oneshot_f32"] for r in runs[0]):
        if what == "loss":
            assert abs(got["loss"] / want["loss"] - 1) < 1e-5
            assert abs(got["grad_norm"] / want["grad_norm"] - 1) < 1e-2
        elif what == "grads":
            # the reference's own f32 precision in train mode
            # (tests/test_torch_port_train.py's docstring)
            rels = {n: _rel(g, want["grads"][n]) for n, g in got["grads"].items()}
            assert max(rels.values()) < 5e-2, sorted(rels.items(), key=lambda kv: -kv[1])[:5]
            assert np.median(list(rels.values())) < 1e-2
        else:
            keys = [k for k in want["stats"] if k.endswith(("running_mean", "running_var"))]
            assert any(k.startswith("mlp_points") for k in keys)
            for k in keys:
                np.testing.assert_allclose(got["state"][k].numpy(), want["stats"][k].numpy(),
                                           rtol=1e-4, atol=1e-4, err_msg=k)


# ---- (c) ----


@pytest.mark.parametrize("what", ["loss", "grads", "stats", "params"])
def test_unequal_chunks_on_data_1_model_4_match_one_process_f64(runs, what):
    ranks, ref = runs
    for r in ranks:
        assert r["unequal"]["chunks"] == [5, 5, 4, 4]
        _held_to_one_process(r["unequal"]["oneshot_f64"], ref["unequal"], what)


# ---- (d) ----


@pytest.mark.parametrize("what", ["loss", "grads", "stats", "params"])
def test_seg_step_on_a_batch_the_data_axis_does_not_divide_matches_one_process_f64(runs, what):
    ranks, ref = runs
    want = ref["seg_whole"]
    for r in ranks:
        assert r["seg_whole"]["held_whole"]
        _held_to_one_process(r["seg_whole"], want, what, stats_tol=1e-10)
        if what == "stats":
            # the witness: taken for a shard of a global batch of 6, the
            # BatchNorms count each row twice and the running variance moves
            shard = r["seg_as_shard"]["state"]
            assert max(float((shard[k] - want["state"][k]).abs().max())
                       for k in want["state"] if k.endswith("running_var")) > 1e-6


# ---- (e) ----


def test_eval_on_data_2_model_2_matches_unsharded(runs):
    ranks, ref = runs
    want = ref["eval"]
    assert len(want) == 7 and 0 < want["d1"] < 1  # tamed heads: live depth
    # the f32 forward runs each convolution on other row counts, so the
    # depth rounds otherwise (sq_rel moves by 1.3e-6 of itself here)
    for r in ranks:
        assert set(r["eval"]) == set(want)
        for k, v in want.items():
            assert abs(r["eval"][k] - v) <= 1e-5 * max(1.0, abs(v)), (k, r["eval"][k], v)


def test_train_cli_on_data_2_model_2_matches_one_process(runs):
    ranks, ref = runs
    want = ref["train"]
    assert want["steps"] == 1 and len(want["val"]) == 1
    for r in ranks:
        got = r["train"]
        assert got["steps"] == 1 and got["val"] == ranks[0]["train"]["val"]
        assert abs(got["train_loss"][0] / want["train_loss"][0] - 1) < 1e-5
    # the checkpoint that rank 0 wrote loads into a bare model, and its
    # statistics are the one-process run's (the bounds of
    # tests/test_torch_port_parallel.py::test_checkpoints_load_across_the_mesh)
    latest = ranks[0]["train"]["latest"]
    assert latest["step"] == 1 and not latest["prefixed"]
    for k, v in latest["running_var"].items():
        torch.testing.assert_close(v, want["latest"]["running_var"][k], rtol=1e-4, atol=1e-5)


def test_infer_on_data_1_model_2_writes_each_output_once(runs):
    one, two = (runs[1]["infer"][m] for m in ("none", "1,2"))
    assert one["paths"] == two["paths"] == ["/p0_depth.npy", "/p1_depth.npy", "/p2_depth.npy"]
    for a, b in zip(one["depth"], two["depth"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


# ---- (f) ----


@pytest.mark.parametrize("what", ["loss", "grads", "stats"])
def test_remat_on_data_1_model_2_equals_the_plain_step(runs, what):
    ranks, ref = runs
    assert [("remat" in r) for r in ranks] == [True, True, False, False]
    for r in ranks[:2]:
        remat, plain = r["remat"]["remat"], r["remat"]["plain"]
        if what == "loss":
            assert abs(remat["loss"] / plain["loss"] - 1) < 1e-13
            assert abs(remat["grad_norm"] / plain["grad_norm"] - 1) < 1e-12
        elif what == "grads":
            rels = {n: _rel(g, plain["grads"][n]) for n, g in remat["grads"].items()
                    if plain["grads"][n].norm() > 0}
            assert set(remat["grads"]) == set(plain["grads"])
            assert max(rels.values()) < 1e-12, sorted(rels.items(), key=lambda kv: -kv[1])[:3]
        else:
            for k, v in plain["state"].items():
                assert float((remat["state"][k].double() - v.double()).abs().max()) < 1e-14, k
        # and the plain step there is the one-process step
        _held_to_one_process(plain, ref["oneshot_f64"], what)


# ---- (g) ----


@pytest.mark.parametrize("mesh", ["data_2_model_2", "data_1_model_4"])
def test_gathers_pass_gradcheck_on_the_ranks(runs, mesh):
    for r in runs[0]:
        g = r["gradcheck"] if mesh == "data_2_model_2" else r["unequal"]["gradcheck"]
        assert g["chunks"] == ([3, 2] if mesh == "data_2_model_2" else [3, 2, 2, 2])
        assert g["gather_patches"] and g["gather_tokens"]
        # the token gather's backward needs its sum over the model group
        assert not g["tokens_without_the_sum"]


# ---- the loader ----


def test_model_ranks_of_a_data_group_hold_the_same_augmented_batches(runs):
    ranks, ref = runs
    c, want = R.MODEL_AXIS_LOADER, ref["loader_depth_sums"]
    per_group = c["batch"] // R.MODEL_MESH.data
    assert len(want) == c["epochs"] * c["n"] // c["batch"]
    for r in ranks:
        got, d = r["loader"], r["data_rank"]
        assert got["sharded"] == [True] * len(want)
        # the data group's slice of each global batch, augmented
        for sums, full in zip(got["depth_sums"], want):
            np.testing.assert_allclose(sums, full[d * per_group : (d + 1) * per_group],
                                       rtol=1e-12)
        assert got["digests"] == ranks[d * R.MODEL_MESH.model]["loader"]["digests"]
    assert ranks[0]["loader"]["digests"] != ranks[2]["loader"]["digests"]
    # the witness: the ranks' own loads differ
    assert ranks[0]["loader"]["own_digests"] != ranks[1]["loader"]["own_digests"]


def test_one_process_has_no_model_axis():
    assert parallel.model_world() == 1 and parallel.data_world() == 1
    assert parallel.data_group() is None and parallel.model_group() is None
    x = torch.arange(6.0).reshape(3, 2)
    # the identity, with no copy
    assert ma.shard_rows(x) is x and ma.gather_patches(x, 3) is x
    assert ma.gather_tokens(x, 3) is x and ma.sum_cotangent(x) is x
