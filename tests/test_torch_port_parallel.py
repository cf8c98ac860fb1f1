"""The port's data parallelism on the CPU: two gloo ranks against one process
and against the JAX mesh.

One module fixture spawns two ranks once (omnifusion_torch.parallel.launch),
which run every check of tests/torch_parallel_ranks.py in sequence, while
this process computes the references: the same steps in one process, and
the JAX train step on a data=2 mesh. The parametrized tests then read both.

- (a) GlobalBatchNorm2d on shards, equal and unequal, against nn.BatchNorm2d
  on the whole batch, float64;
- (b) BerHu's cutoff and the cross-entropy's count over the global batch;
- (c) the loader's rank slices put back together;
- (d) the one-shot train step at global batch 2 over 2 ranks against the
  port's one-process step in float64, and against the JAX mesh step in f32
  at the bounds of tests/test_torch_port_train.py::test_train_step_matches_jax;
- (e) the iterative and segmentation steps against one process, float64;
- (f) cli.test with --mesh 2 against the run without it;
- (g) --mesh's rules and messages against the JAX build_mesh, and the
  train entry point's refusal of a batch the data axis does not divide;
- (h) checkpoints across the mesh, both ways;
- (i) a data axis that does not divide the batch (three more ranks, spawned
  by a second fixture): cli.test with --mesh 3 --batch 8 against the run
  without it, the segmentation step on a batch every rank holds whole
  against one process in float64 (its global BatchNorms keep the local
  count), the cross-entropy of such a batch, and cli.train_sem.
"""

import argparse
import concurrent.futures
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as R
from omnifusion_tpu.cli.common import build_mesh as jax_build_mesh
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.parallel import batch_sharding, make_mesh
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.training.trainer import _forward_loss
from omnifusion_torch import parallel
from omnifusion_torch.cli import common
from omnifusion_torch.cli import infer as infer_cli
from omnifusion_torch.cli import test as test_cli
from omnifusion_torch.cli import train as train_cli
from omnifusion_torch.losses import berhu_loss
from omnifusion_torch.models import cross_entropy_ignore, init_weights, state_dict_from_jax
from omnifusion_torch.parallel.launch import spawn

SPAWN_TIMEOUT_S = 240


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


def _jax_init():
    kw = dict(spec=JaxSpec.create(R.ERP, R.PATCH, (80, 80), 4), depth=1,
              encoder_stages=R.ONE_BLOCK)
    rgb = jnp.asarray(R.depth_batch(0)["rgb"][:1])
    v = jax.tree_util.tree_map(np.array, jax.jit(JaxSphericalFusion(**kw).init)(
        jax.random.PRNGKey(3), rgb))
    return v, JaxSphericalFusion(**kw, kernel_impl="pallas_full")


def _jax_mesh_step(v, model) -> dict:
    """The JAX train step on a data=2 mesh, the batch sharded over it."""
    batch = R.depth_batch(0)
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
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
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "grads": grads, "stats": stats}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (rank order) and this process's references."""
    work = tmp_path_factory.mktemp("parallel")
    v, jax_model = _jax_init()
    v["params"]["trunk"]["pred"]["kernel"] *= 0.05
    v["params"]["trunk"]["weight_pred"]["kernel"] *= 0.05
    v["params"]["trunk"]["pred"]["bias"] += 2.0
    init = {"oneshot": state_dict_from_jax(v),
            "iterative": _tame(init_weights(R.build("iterative"), 5).state_dict()),
            "seg": init_weights(R.build("seg"), 6).state_dict()}
    torch.save(init, work / "init.pt")
    # the one-process checkpoint that a 2-rank run resumes (h); only its
    # latest is kept (each file is about 0.3 GB)
    bare = R.cli_args(["--batch", "2", "--synthetic_size", "2", "--workers", "1", "--mesh",
                       "none", "--visualize_interval", "0", "--epochs", "1", "--save_path",
                       str(work / "bare_run"), "--save_checkpoint", str(work / "bare")],
                      train=True)
    bare_history = train_cli.run_training(bare)
    (work / "bare" / "latest.pt").rename(work / "bare.pt")
    shutil.rmtree(work / "bare")

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.run_all, 2, (str(work),), lambda r: "cpu", "gloo",
                            SPAWN_TIMEOUT_S)
        ref = {
            "jax_mesh": _jax_mesh_step(v, jax_model),
            "oneshot_f64": R.step("oneshot", init["oneshot"], R.depth_batch(0)),
            "iterative_f64": R.step("iterative", init["iterative"], R.depth_batch(0),
                                    confidence=False),
            "seg_f64": R.step("seg", init["seg"], R.seg_batch(1)),
            "eval": test_cli.run_eval(R.cli_args(
                ["--synthetic_size", "3", "--batch", "2", "--mesh", "none",
                 "--visualize_interval", "0", "--save_path", str(work / "eval_ref")])),
            "bare_history": bare_history,
        }
        ranks = ranks.result()
    ref["bare_latest"] = R.read_checkpoint(str(work / "bare.pt"))
    (work / "bare.pt").unlink()
    return ranks, ref


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


# ---- (a) ----


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shards", sorted(R.BN_SHARDS))
def test_global_batchnorm_matches_batchnorm_on_the_whole_batch(runs, shards, rank):
    errs = dict(runs[0][rank]["batchnorm"][shards])
    scale = errs.pop("scale")
    assert scale > 0.1  # the input gradient is live
    assert max(errs.values()) < 1e-10, errs


# ---- (b) ----


@pytest.mark.parametrize("name", ["berhu", "cross_entropy"])
def test_losses_reduce_over_the_global_batch(runs, name):
    ranks = runs[0]
    x, args = R.loss_inputs(name)
    w = torch.ones(x.shape[1:], dtype=torch.float64, requires_grad=True)
    fn = berhu_loss if name == "berhu" else cross_entropy_ignore
    want = fn(x * w, **args)
    want.backward()
    for r in ranks:
        assert abs(r["loss"][name]["loss"] - want.item()) < 1e-12 * abs(want.item())
        assert _rel(r["loss"][name]["grad"], w.grad) < 1e-12
    if name == "berhu":  # the ranks' own cutoffs differ
        maxima = [r["loss"][name]["local_max"] for r in ranks]
        assert max(maxima) > 1.2 * min(maxima), maxima
    else:  # and so do their counts of valid labels
        counts = [int((a != -1).sum()) for a in args["labels"].chunk(2)]
        assert counts[0] > 1.2 * counts[1], counts


# ---- (c) ----


@pytest.mark.parametrize("case", sorted(R.LOADER_CASES))
def test_loader_slices_make_the_single_device_batches(runs, case):
    want = R.loader_batches(case)
    got = [r["loader"][case] for r in runs[0]]
    assert len(got[0]) == len(got[1]) == len(want)
    for (b0, s0), (b1, s1), (w, _) in zip(*got, want):
        assert s0 == s1
        if s0:
            assert b0 + b1 == w
        else:  # a batch the ranks cannot split: whole on both, as JAX replicates it
            assert b0 == b1 == w and len(w) % 2 == 1
    if case == "ragged_tail":
        assert not got[0][-1][1] and got[0][0][1]


# ---- (d), (e) ----


@pytest.mark.parametrize("kind", ["oneshot", "iterative", "seg"])
@pytest.mark.parametrize("what", ["loss", "grads", "stats", "params"])
def test_step_on_two_ranks_matches_one_process_f64(runs, kind, what):
    ranks, ref = runs[0], runs[1][f"{kind}_f64"]
    for r in ranks:
        got = r[f"{kind}_f64"]
        assert "GlobalBatchNorm2d" in got["global_norms"]
        if what == "loss":
            assert abs(got["loss"] / ref["loss"] - 1) < 1e-10
            assert abs(got["grad_norm"] / ref["grad_norm"] - 1) < 1e-8
        elif what == "grads":
            assert set(got["grads"]) == set(ref["grads"])
            rels = {n: _rel(g, ref["grads"][n]) for n, g in got["grads"].items()
                    if ref["grads"][n].norm() > 0}
            assert max(rels.values()) < 1e-8, sorted(rels.items(), key=lambda kv: -kv[1])[:3]
        else:
            keys = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
            if what == "params":
                keys = [k for k in ref["state"] if k in ref["grads"]]
            assert keys
            for k in keys:
                err = float((got["state"][k] - ref["state"][k]).abs().max())
                assert err < 1e-8, (k, err)
    assert ref["global_norms"] == ["BatchNorm2d"]  # one process keeps nn.BatchNorm2d


@pytest.mark.parametrize("what", ["loss", "grads", "bn_stats"])
def test_oneshot_step_on_two_ranks_matches_jax_mesh(runs, what):
    want = runs[1]["jax_mesh"]
    got = runs[0][0]["oneshot_f32"]
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


# ---- (f) ----


def test_sharded_eval_matches_unsharded(runs):
    ref = runs[1]["eval"]
    for r in runs[0]:
        e = r["eval"]
        assert set(e["avg"]) == set(ref) and len(ref) == 7
        for k, v in ref.items():
            assert abs(e["avg"][k] - v) < 1e-6, (k, e["avg"][k], v)
        # the rank's own median differs from the batch's, and scaling by it
        # moves the metrics far past the bound above
        assert abs(e["local_median"] / e["global_median"] - 1) > 1e-2
    assert abs(runs[0][0]["eval"]["local_abs_rel"] - runs[0][1]["eval"]["local_abs_rel"]) > 1e-4


# ---- (g) ----

MESH_CASES = [("auto", 8), ("auto", 6), ("auto", 7), ("none", 8), ("4", 8), ("8", 8),
              ("16", 8), ("3", 8), ("2,2", 8), ("x", 8), ("0", 8)]


@pytest.mark.parametrize("spec,batch", MESH_CASES)
def test_parse_mesh_follows_jax_build_mesh(capsys, spec, batch):
    def outcome(fn):
        try:
            return ("ok", fn()), capsys.readouterr().out
        except SystemExit as e:
            return ("exit", str(e)), capsys.readouterr().out

    (kind, val), out = outcome(lambda: parallel.parse_mesh(spec, batch, 8, "cpu"))
    (jkind, jval), jout = outcome(
        lambda: jax_build_mesh(argparse.Namespace(mesh=spec, batch=batch)))
    assert out == jout
    if jkind == "ok" and jval is not None and dict(jval.shape)["model"] > 1:
        # the model axis is not ported: it refuses, and never becomes data ranks
        assert kind == "exit" and "patch axis is not ported yet (see ROADMAP)" in val
    elif jkind == "ok":
        # a data axis that does not divide the batch too ("3", 8): the JAX
        # build_mesh returns it, and only the train entry point refuses
        # (test_train_cli_alone_refuses_a_batch_the_data_axis_does_not_divide)
        assert kind == "ok"
        assert (val.shape if val is not None else None) == (
            dict(jval.shape) if jval is not None else None)
    else:
        assert (kind, val) == (jkind, jval)


@pytest.mark.parametrize("cli", ["train", "train_sem", "test", "infer"])
def test_train_cli_alone_refuses_a_batch_the_data_axis_does_not_divide(cli):
    # omnifusion_tpu/cli/train.py:101-103 refuses; cli/test.py:88,
    # cli/infer.py:115 and cli/train_sem.py:106 replicate such a batch
    args = R.cli_args(["--mesh", "3", "--batch", "8"], train=cli.startswith("train"))
    if cli == "train":
        with pytest.raises(SystemExit) as e:
            train_cli.run_training(args)
        assert str(e.value) == "--batch 8 not divisible by data axis 3"
    else:
        assert common.build_mesh(args).shape == {"data": 3, "model": 1}


@pytest.mark.parametrize("spec", ["2", "1,2"])
def test_mesh_never_falls_back(monkeypatch, spec):
    # --mesh 2 on a machine with one card (here: none), and a model axis
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = R.cli_args(["--mesh", spec])
    args.device = None
    with pytest.raises(SystemExit) as e:
        common.build_mesh(args)
    if spec == "2":
        assert "needs 2 devices but only 1 are available (platform='cuda')" in str(e.value)
    else:
        assert "patch axis is not ported yet" in str(e.value)


def test_mesh_under_torchrun_takes_the_world_size(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    args = R.cli_args(["--batch", "8"])
    assert common.build_mesh(args).shape == {"data": 4, "model": 1}
    args.mesh = "2"
    with pytest.raises(SystemExit, match="the data axis is the world size, 4"):
        common.build_mesh(args)


# ---- (h) ----


@pytest.mark.parametrize("way", ["mesh_to_bare", "bare_to_mesh"])
def test_checkpoints_load_across_the_mesh(runs, way):
    # each checkpoint loads strictly into a bare model of the CLI's
    # configuration (torch_parallel_ranks.read_checkpoint)
    ranks, ref = runs
    if way == "mesh_to_bare":
        mesh = ranks[0]["checkpoint"]["mesh"]
        assert mesh["steps"] == mesh["latest"]["step"] == 1 and not mesh["latest"]["prefixed"]
        # one step from the same seed on the same batch: the statistics are
        # the one-process run's
        bare = ref["bare_latest"]["running_var"]
        for k, v in mesh["latest"]["running_var"].items():
            torch.testing.assert_close(v, bare[k], rtol=1e-4, atol=1e-5)
        assert mesh["val"] == ranks[1]["checkpoint"]["mesh"]["val"]
    else:
        # the 2-rank run resumed the one-process checkpoint at step 1
        assert ref["bare_history"]["steps"] == 1
        resumed = ranks[0]["checkpoint"]["resumed"]
        assert all(r["checkpoint"]["resumed"]["steps"] == 2 for r in ranks)
        assert resumed["latest"]["step"] == 2 and not resumed["latest"]["prefixed"]
        assert np.isfinite(resumed["train_loss"]).all()


def test_infer_cli_spawns_its_ranks(tmp_path):
    # --mesh 2 outside torchrun: two spawned gloo ranks, each answering its
    # slice of every batch (3 panoramas at batch 2: slices of 1, then 1 and 0)
    rng = np.random.default_rng(0)
    (tmp_path / "in").mkdir()
    for i in range(3):
        np.save(tmp_path / "in" / f"p{i}.npy", rng.random((*R.ERP, 3), dtype=np.float32))
    base = ["--input", str(tmp_path / "in"), "--device", "cpu", "--erp_size", "64,128",
            "--patchsize", "32", "--batch", "2", "--seed", "0"]
    one = infer_cli.run_infer(infer_cli.build_parser().parse_args(
        base + ["--mesh", "none", "--save_path", str(tmp_path / "one")]))
    two = infer_cli.run_infer(infer_cli.build_parser().parse_args(
        base + ["--mesh", "2", "--save_path", str(tmp_path / "two")]))
    assert [p.replace("/two/", "/one/") for p in two] == one
    for a, b in zip(one, two):
        np.testing.assert_allclose(np.load(b), np.load(a), rtol=1e-5, atol=1e-6)


# ---- (i) ----


@pytest.fixture(scope="module")
def replicated(tmp_path_factory):
    """REPLICATED_RANKS ranks' results, and this process's references (one
    thread, as each rank runs)."""
    work = tmp_path_factory.mktemp("replicated")
    init = {"seg": init_weights(R.build("seg"), 6).state_dict()}
    torch.save(init, work / "init.pt")
    # cli.test's weights: the seeded full-depth model, heads tamed
    model = init_weights(common.build_model(R.cli_args([]), device="cpu"), 0)
    torch.save(_tame(model.state_dict()), work / "tamed.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.run_replicated, R.REPLICATED_RANKS, (str(work),),
                            lambda r: "cpu", "gloo", SPAWN_TIMEOUT_S)
        saved = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ref = {"eval": R.replicated_eval(str(work), "none"),
                   "seg_f64": R.step("seg", init["seg"], R.seg_batch(1, b=3)),
                   # one rank of the same path (DDP, the global BatchNorms)
                   "train_sem": R.replicated_train_sem(str(work / "sem_ref"), "1")}
        finally:
            torch.set_num_threads(saved)
        ranks = ranks.result()
    x, args = R.loss_inputs("cross_entropy")
    ref["cross_entropy"] = cross_entropy_ignore(x, **args).item()
    return ranks, ref


def test_eval_on_a_data_axis_that_does_not_divide_the_batch(replicated):
    ranks, ref = replicated
    want = ref["eval"]
    assert [s for _, s in want["preds"]] == [False, False]
    assert 0 < want["avg"]["d1"] < 1  # tamed heads: live depth
    for rank, r in enumerate(ranks):
        e = r["eval"]
        assert set(e["avg"]) == set(want["avg"]) and len(want["avg"]) == 7
        for k, v in want["avg"].items():
            assert abs(e["avg"][k] - v) <= 1e-6 * max(1.0, abs(v)), (k, e["avg"][k], v)
        # the batch of 8 runs whole on every rank, the batch of 3 is split
        (whole, sharded_whole), (part, sharded_part) = e["preds"]
        assert (sharded_whole, sharded_part) == (False, True)
        assert torch.equal(whole, want["preds"][0][0])  # bit for bit
        torch.testing.assert_close(part, want["preds"][1][0][rank : rank + 1],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("what", ["loss", "grads", "stats", "num_batches_tracked"])
def test_seg_step_on_a_batch_every_rank_holds_whole_matches_one_process_f64(replicated, what):
    ranks, ref = replicated
    want = ref["seg_f64"]
    for r in ranks:
        got = r["seg_whole"]
        assert "GlobalBatchNorm2d" in got["global_norms"]
        if what == "loss":
            assert abs(got["loss"] / want["loss"] - 1) < 1e-10
            assert abs(got["grad_norm"] / want["grad_norm"] - 1) < 1e-8
        elif what == "grads":
            rels = {n: _rel(g, want["grads"][n]) for n, g in got["grads"].items()
                    if want["grads"][n].norm() > 0}
            assert set(got["grads"]) == set(want["grads"])
            assert max(rels.values()) < 1e-8, sorted(rels.items(), key=lambda kv: -kv[1])[:3]
        elif what == "stats":
            keys = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
            for k in keys:
                err = float((got["state"][k] - want["state"][k]).abs().max())
                assert err < 1e-10, (k, err)
            # the witness: taken for a shard of a global batch of 9, the
            # running variance is unbiased with 3 times the count
            shard = r["seg_as_shard"]["state"]
            assert max(float((shard[k] - want["state"][k]).abs().max())
                       for k in keys if k.endswith("running_var")) > 1e-6
        else:
            for k, v in want["state"].items():
                if k.endswith("num_batches_tracked"):
                    assert int(got["state"][k]) == int(v) == 1, k


def test_cross_entropy_of_a_batch_every_rank_holds_whole_is_its_mean(replicated):
    # world * sum / (world * count): the local mean, whose gradient DDP
    # then averages over equal copies
    ranks, ref = replicated
    for r in ranks:
        assert abs(r["cross_entropy"] / ref["cross_entropy"] - 1) < 1e-12


def test_train_sem_on_a_data_axis_that_does_not_divide_the_batch(replicated):
    # every batch runs whole on every rank: the epoch's loss and the
    # validation mIoU (its confusion counts taken once) are those of one
    # rank (--mesh 1), whose BatchNorms run the same code; against
    # nn.BatchNorm2d (no mesh), whose f32 sums round otherwise, AdamW's
    # near-sign first updates move the epoch's loss by 2e-4
    ranks, ref = replicated
    want = ref["train_sem"]
    for r in ranks:
        got = r["train_sem"]
        assert abs(got["train_loss"][0] / want["train_loss"][0] - 1) < 1e-5
        assert abs(got["miou"][0] - want["miou"][0]) < 1e-3, (got["miou"], want["miou"])
