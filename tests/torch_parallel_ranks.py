"""What the ranks of the multi-rank tests run (tests/test_torch_port_parallel.py,
tests/test_torch_port_model_axis.py, and the card's case in
tests/test_torch_port_cuda.py).

Each function runs in a rank that ``omnifusion_torch.parallel.launch.spawn``
started, with its process group up, and returns plain numbers and CPU
tensors for the test process to hold against the one-process references.
This module imports nothing of JAX: the ranks are fresh interpreters that
import it by name.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from omnifusion_torch import parallel
from omnifusion_torch.data import DataLoader, StanfordDataset
from omnifusion_torch.data.loader import Batch
from omnifusion_torch.losses import berhu_loss
from omnifusion_torch.models import (
    SphericalFusion,
    SphericalFusionIterative,
    SphericalFusionSeg,
    cross_entropy_ignore,
)
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.training import create_train_state, train_step, train_step_sem

ERP, PATCH = (64, 128), 32
ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
LR, WD, T0, T_MULT, STEPS_PER_EPOCH = 1e-4, 0.01, 5, 2, 3
SEG_CLASSES = 5
# BatchNorm inputs, (N, C, H, W): shards of 2 and 2, and of 2 and 3
BN_SHARDS = {"equal": (2, 2), "unequal": (2, 3)}


def depth_batch(seed: int, b: int = 2) -> dict[str, np.ndarray]:
    """rgb, depth and mask of ``b`` panoramas, as tests/test_torch_port_train.py
    draws them; sample i's depth is offset by i, so that the samples'
    maxima and medians differ."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, *ERP, 1)) > 0.2).astype(np.float32)
    depth = (rng.random((b, *ERP, 1)) * 7 + 0.3).astype(np.float32)
    depth = (depth + np.arange(b, dtype=np.float32)[:, None, None, None]) * mask
    return {"rgb": rng.random((b, *ERP, 3), dtype=np.float32), "depth": depth, "mask": mask}


def seg_batch(seed: int, b: int = 2) -> dict[str, np.ndarray]:
    """rgb and labels; sample i ignores (-1) a share 0.2 + 0.3 i of its
    pixels, so the ranks hold different counts of valid labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, SEG_CLASSES, size=(b, *ERP)).astype(np.int64)
    for i in range(b):
        labels[i][rng.random(ERP) < 0.2 + 0.3 * i] = -1
    return {"rgb": rng.random((b, *ERP, 3), dtype=np.float32), "labels": labels}


def spec() -> ProjectionSpec:
    return ProjectionSpec.create(ERP, PATCH, (80, 80), 4)


def build(kind: str, device="cpu", remat: bool = False) -> torch.nn.Module:
    """The test configuration of each model: one-block stages, depth 1."""
    kw = dict(depth=1, encoder_stages=ONE_BLOCK, device=device, remat=remat)
    if kind == "iterative":
        return SphericalFusionIterative(spec(), num_iters=2, **kw)
    if kind == "seg":
        return SphericalFusionSeg(spec(), num_classes=SEG_CLASSES, **kw)
    return SphericalFusion(spec(), **kw)


def step(kind: str, state_dict: dict, batch: dict, dtype=torch.float64, device="cpu",
         confidence: bool = True, whole: bool = False, remat: bool = False) -> dict:
    """One train step of ``kind`` from ``state_dict`` on ``batch`` (numpy,
    this process's part): in DDP when a group is up, else in one process.
    ``whole``: the batch is a ``Batch`` that every data group holds whole
    (``sharded`` false), as the loader gives a batch the data axis cannot
    split. Returns the reported loss and grad norm, the averaged gradients,
    and the parameters and BatchNorm statistics after the step, on the
    CPU."""
    model = build(kind, device, remat).to(dtype)
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(model, LR, WD, T0, T_MULT, STEPS_PER_EPOCH)
    if parallel.is_distributed():
        state.model = parallel.wrap(model, device)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()}
    if whole:
        tb = Batch(tb, sharded=False)
    if kind == "seg":
        m = train_step_sem(state, tb)
    else:
        m = train_step(state, tb, confidence)
    return {
        "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
        "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                  if p.grad is not None},
        "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
        "global_norms": sorted({type(m).__name__ for m in model.modules()
                                if isinstance(m, torch.nn.BatchNorm2d)}),
    }


def shard(batch: dict, rank: int, world: int) -> dict:
    k = next(iter(batch.values())).shape[0] // world
    return {key: v[rank * k : (rank + 1) * k] for key, v in batch.items()}


def batchnorm_check(kind: str, device="cpu") -> dict:
    """GlobalBatchNorm2d on this rank's shard against nn.BatchNorm2d on the
    whole batch, float64: the largest differences of the output, the input
    gradient (this rank's rows), the affine gradients (summed over the
    ranks) and the running statistics."""
    rank = parallel.rank()
    sizes = BN_SHARDS[kind]
    rng = np.random.default_rng(21)
    c = 6
    x = torch.from_numpy(rng.standard_normal((sum(sizes), c, 5, 7)) * 3 + 1.5).to(device)
    g = torch.from_numpy(rng.standard_normal(x.shape)).to(device)
    w0 = torch.from_numpy(rng.random(c) + 0.5)
    b0 = torch.from_numpy(rng.standard_normal(c))

    def norm(cls):
        bn = cls(c, device=device, dtype=torch.float64)
        with torch.no_grad():
            bn.weight.copy_(w0)
            bn.bias.copy_(b0)
        return bn

    ref = norm(torch.nn.BatchNorm2d)
    xr = x.clone().requires_grad_()
    (ref(xr) * g).sum().backward()
    y_ref = ref(x.clone()).detach()  # a second step: the running stats move twice

    rows = slice(sum(sizes[:rank]), sum(sizes[: rank + 1]))
    bn = norm(parallel.GlobalBatchNorm2d)
    xs = x[rows].clone().requires_grad_()
    (bn(xs) * g[rows]).sum().backward()
    y = bn(x[rows].clone()).detach()
    dw = parallel.all_reduce_(bn.weight.grad.clone())
    db = parallel.all_reduce_(bn.bias.grad.clone())

    def err(a, b):
        return float((a - b).abs().max())

    return {
        "out": err(y, y_ref[rows]), "dx": err(xs.grad, xr.grad[rows]),
        "dweight": err(dw, ref.weight.grad), "dbias": err(db, ref.bias.grad),
        "running_mean": err(bn.running_mean, ref.running_mean),
        "running_var": err(bn.running_var, ref.running_var),
        "scale": float(xr.grad.abs().max()),
    }


class _Scale(torch.nn.Module):
    """pred = x * w, w one sample's shape: a module whose gradient is the
    loss's gradient summed over the batch, for DDP to average."""

    def __init__(self, shape):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(shape, dtype=torch.float64))

    def forward(self, x):
        return x * self.w


def loss_check(name: str) -> dict:
    """berhu_loss or cross_entropy_ignore on this rank's shard, through a
    DDP-wrapped module: the reported loss (the mean over the ranks) and the
    gradient that DDP delivers."""
    rank, world = parallel.rank(), parallel.world()
    x, args = loss_inputs(name)
    model = torch.nn.parallel.DistributedDataParallel(_Scale(x.shape[1:]))
    rows = shard({"x": x, **args}, rank, world)
    out = model(rows.pop("x"))
    loss = berhu_loss(out, **rows) if name == "berhu" else cross_entropy_ignore(out, **rows)
    loss.backward()
    local_max = float((rows["gt"] - out).abs().max()) if name == "berhu" else None
    return {"loss": parallel.mean_over_ranks(loss.detach()).item(),
            "grad": model.module.w.grad.clone(), "local_max": local_max}


def loss_inputs(name: str) -> tuple[torch.Tensor, dict]:
    """The global batch of a loss check, float64: for BerHu, samples whose
    largest |gt - pred| differ (sample 1's is larger); for the
    cross-entropy, labels of which sample 1 ignores the more."""
    rng = np.random.default_rng(5)
    if name == "berhu":
        x = torch.from_numpy(rng.random((4, 8, 16, 1)) * 3)
        gt = torch.from_numpy(rng.random((4, 8, 16, 1)) * 3)
        gt[2:] *= 2.5
        mask = torch.from_numpy((rng.random((4, 8, 16, 1)) > 0.3).astype(np.float64))
        return x, {"gt": gt, "mask": mask}
    x = torch.from_numpy(rng.standard_normal((4, 8, 16, SEG_CLASSES)))
    labels = torch.from_numpy(rng.integers(0, SEG_CLASSES, size=(4, 8, 16)))
    labels[0][torch.from_numpy(rng.random((8, 16)) < 0.1)] = -1
    labels[3][torch.from_numpy(rng.random((8, 16)) < 0.7)] = -1
    return x, {"labels": labels}


class IndexDataset:
    """Sample i: (i, 2i), so the loader's batches say which samples they hold."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i], np.int64), np.array([2 * i], np.int64)


LOADER_CASES = {
    "shuffled": dict(n=12, batch=4, shuffle=True, drop_last=True),
    "drop_last": dict(n=11, batch=4, shuffle=True, drop_last=True),
    "ragged_tail": dict(n=11, batch=4, shuffle=False, drop_last=False),
    "even_tail": dict(n=10, batch=4, shuffle=True, drop_last=False),
}


def loader_batches(case: str, rank: int = 0, world: int = 1) -> list[tuple[list, bool]]:
    """(sample indices, sharded) of each batch, over two epochs."""
    c = LOADER_CASES[case]
    loader = DataLoader(IndexDataset(c["n"]), c["batch"], shuffle=c["shuffle"],
                        drop_last=c["drop_last"], num_workers=2, seed=3, rank=rank, world=world)
    return [(b["rgb"][:, 0].tolist(), b.sharded) for _ in range(2) for b in loader]


def cli_args(extra: list[str], train: bool = False) -> argparse.Namespace:
    from omnifusion_torch.cli.common import add_common_args

    parser = argparse.ArgumentParser()
    add_common_args(parser, train=train)
    return parser.parse_args(["--dataset", "synthetic", "--device", "cpu", "--erp_size",
                              "64,128", "--patchsize", "32", "--seed", "0", *extra])


def eval_check(save_path: str) -> dict:
    """cli.test's run_eval over 3 synthetic panoramas at batch 2 (one batch
    split over the ranks, one replicated), and the metrics of this rank's
    slice of the first batch alone, median-scaled by its own medians."""
    from omnifusion_torch.cli import test as test_cli
    from omnifusion_torch.data import SyntheticDataset
    from omnifusion_torch.evaluation import compute_depth_metrics
    from omnifusion_torch.evaluation.metrics import masked_median

    args = cli_args(["--synthetic_size", "3", "--batch", "2", "--mesh", "2",
                     "--visualize_interval", "0", "--save_path", save_path])
    avg = test_cli.run_eval(args)
    # the per-rank medians that a per-rank eval would scale by
    ds = SyntheticDataset(3, *ERP, seed=0)
    rgb, depth, mask = (torch.from_numpy(np.stack(c)) for c in zip(ds[0], ds[1]))
    model = test_cli.build_model(args)
    with torch.inference_mode():
        pred = model(rgb)
    r = parallel.rank()
    local, _ = compute_depth_metrics(pred[r : r + 1], depth[r : r + 1], mask[r : r + 1])
    return {"avg": avg, "local_abs_rel": local["abs_rel"].item(),
            "local_median": masked_median(depth[r : r + 1], mask[r : r + 1]).item(),
            "global_median": masked_median(depth, mask).item()}


def read_checkpoint(path: str) -> dict:
    """What the tests hold of a train checkpoint (the file is then
    removed: at this size each is about 0.3 GB): its step, whether its
    model keys carry DDP's prefix, whether they load strictly into a bare
    model of the CLI's configuration, and its BatchNorms' running
    variances."""
    from omnifusion_torch.cli.common import build_model

    ckpt = torch.load(path, weights_only=True)
    model = build_model(cli_args([]), device="cpu")
    model.load_state_dict(ckpt["model"], strict=True)
    return {"step": ckpt["step"], "prefixed": any(k.startswith("module.") for k in ckpt["model"]),
            "running_var": {k: v for k, v in ckpt["model"].items() if k.endswith("running_var")}}


def checkpoint_check(workdir: str) -> dict:
    """A 2-rank training run through cli.train (one step, a validation and
    its checkpoints), then a 2-rank run resumed from the one-process
    checkpoint ``workdir/bare.pt``; rank 0 reads each run's latest
    checkpoint and removes the run's checkpoints."""
    import shutil

    from omnifusion_torch.cli import train as train_cli

    base = ["--batch", "2", "--synthetic_size", "2", "--workers", "1", "--mesh", "2",
            "--visualize_interval", "0"]
    out = {}
    for name, extra in (("mesh", ["--epochs", "1"]),
                        ("resumed", ["--epochs", "2", "--checkpoint",
                                     os.path.join(workdir, "bare.pt")])):
        ckpt = os.path.join(workdir, name)
        hist = train_cli.run_training(cli_args(
            base + extra + ["--save_path", os.path.join(workdir, f"{name}_run"),
                            "--save_checkpoint", ckpt], train=True))
        out[name] = {"steps": hist["steps"], "val": hist["val"],
                     "train_loss": hist["train_loss"]}
        if parallel.rank() == 0:
            out[name]["latest"] = read_checkpoint(os.path.join(ckpt, "latest.pt"))
            shutil.rmtree(ckpt)
        parallel.barrier()
    return out


def run_all(workdir: str) -> dict:
    """Every check of tests/test_torch_port_parallel.py, in sequence. The
    one-shot model's weights come from ``workdir/init.pt`` (the JAX init,
    converted); the other models' from init_weights."""
    torch.set_num_threads(1)
    rank, world = parallel.rank(), parallel.world()
    out = {"rank": rank, "world": world}
    out["batchnorm"] = {k: batchnorm_check(k) for k in BN_SHARDS}
    out["loss"] = {k: loss_check(k) for k in ("berhu", "cross_entropy")}
    out["loader"] = {k: loader_batches(k, rank, world) for k in LOADER_CASES}
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=True)
    batch = shard(depth_batch(0), rank, world)
    out["oneshot_f64"] = step("oneshot", init["oneshot"], batch)
    out["oneshot_f32"] = step("oneshot", init["oneshot"], batch, torch.float32)
    out["iterative_f64"] = step("iterative", init["iterative"], batch, confidence=False)
    out["seg_f64"] = step("seg", init["seg"], shard(seg_batch(1), rank, world))
    out["eval"] = eval_check(os.path.join(workdir, f"eval_{rank}"))
    out["checkpoint"] = checkpoint_check(workdir)
    return out


REPLICATED_RANKS, REPLICATED_BATCH = 3, 8  # a batch the data axis does not divide


def replicated_eval(workdir: str, mesh: str) -> dict:
    """cli.test's run_eval over 11 synthetic panoramas at batch 8 with
    ``--mesh`` (under 3 ranks: a batch of 8 that every rank runs whole, then
    one of 3 split over them), from ``workdir/tamed.pt``: the metrics, and
    the depth of each batch that this process ran."""
    import omnifusion_torch.training as training
    from omnifusion_torch.cli import test as test_cli

    preds, real = [], training.eval_step

    def eval_step(model, batch, confidence=True):
        out = real(model, batch, confidence)
        preds.append((out[2][..., 0].clone(), batch.sharded))
        return out

    training.eval_step = eval_step  # run_eval imports it at the call
    try:
        avg = test_cli.run_eval(cli_args(
            ["--synthetic_size", "11", "--batch", str(REPLICATED_BATCH), "--mesh", mesh,
             "--checkpoint", os.path.join(workdir, "tamed.pt"), "--visualize_interval", "0",
             "--save_path", os.path.join(workdir, f"eval_{mesh}_{parallel.rank()}")]))
    finally:
        training.eval_step = real
    return {"avg": avg, "preds": preds}


def replicated_train_sem(save_path: str, mesh: str) -> dict:
    """One epoch of cli.train_sem at batch 4 with ``--mesh`` (under 3 ranks
    every batch of its 32 training and 8 validation panoramas runs whole on
    each rank): the history."""
    from omnifusion_torch.cli import train_sem

    args = train_sem.build_parser().parse_args(
        ["--dataset", "synthetic", "--device", "cpu", "--erp_size", "64,128", "--patchsize",
         "32", "--seed", "0", "--batch", "4", "--epochs", "1", "--workers", "1",
         "--num_classes", str(SEG_CLASSES), "--mesh", mesh, "--save_path", save_path])
    return train_sem.run_training_sem(args)


def run_replicated(workdir: str) -> dict:
    """The checks of a data axis that does not divide the batch, on
    REPLICATED_RANKS ranks: cli.test, the segmentation step on a batch
    every rank holds whole (and, as a witness, the same batch taken for a
    shard of a global batch), the cross-entropy of such a batch, and
    cli.train_sem."""
    torch.set_num_threads(1)
    rank = parallel.rank()
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=True)["seg"]
    batch = seg_batch(1, b=3)
    out = {"eval": replicated_eval(workdir, "3"),
           "seg_whole": step("seg", init, batch, whole=True),
           "seg_as_shard": step("seg", init, batch)}
    x, args = loss_inputs("cross_entropy")
    out["cross_entropy"] = cross_entropy_ignore(x, **args).item()
    out["train_sem"] = replicated_train_sem(os.path.join(workdir, f"sem_{rank}"), "3")
    return out


@contextlib.contextmanager
def plain_versions():
    """Every kernel launch on its plain version (which then computes in the
    input's dtype, float64 included), as chip_smoke.py's float64 witness."""
    import omnifusion_torch.ops.quad_blend as qb
    import omnifusion_torch.ops.upsample as ups

    saved = qb._blend_kernel, qb._spread_kernel, ups._up2x_kernel, ups._adjoint_kernel
    qb._blend_kernel, qb._spread_kernel = qb.quad_blend_plain, qb.quad_spread_plain
    ups._up2x_kernel, ups._adjoint_kernel = ups.up2x_plain, ups.up2x_adjoint_plain
    try:
        yield
    finally:
        qb._blend_kernel, qb._spread_kernel, ups._up2x_kernel, ups._adjoint_kernel = saved


def kernel_launches() -> dict:
    from omnifusion_torch.ops.quad_blend import quad_blend, quad_spread
    from omnifusion_torch.ops.upsample import up2x, up2x_adjoint

    return {f.__name__: f.launches for f in (quad_blend, quad_spread, up2x, up2x_adjoint)}


def card_steps(state_dict: dict, device) -> dict:
    """The one-shot step on the card: in float64 on the plain versions, and
    in f32 (TF32 off) through the kernels, with the kernels' launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = depth_batch(0)
    if parallel.is_distributed():
        batch = shard(batch, parallel.rank(), parallel.world())
    with plain_versions():
        f64 = step("oneshot", state_dict, batch, device=device)
    before = kernel_launches()
    f32 = step("oneshot", state_dict, batch, torch.float32, device=device)
    after = kernel_launches()
    return {"f64": f64, "f32": f32, "launches": {k: after[k] - before[k] for k in after}}


def card_checks(state_dict: dict) -> dict:
    """tests/test_torch_port_cuda.py's case on two gloo ranks sharing the
    card: the BatchNorm check and the one-shot steps of ``card_steps``."""
    torch.set_num_threads(1)
    device = parallel.device()
    return {"batchnorm": {k: batchnorm_check(k, device) for k in BN_SHARDS},
            **card_steps(state_dict, device)}


# ---- the mesh's model axis (tests/test_torch_port_model_axis.py) ----
MODEL_MESH = parallel.Mesh(2, 2)


def data_part(batch: dict) -> tuple[dict, bool]:
    """This data group's part of a global batch and whether the group holds
    it whole (a batch the data axis does not divide), as the loader gives
    it."""
    n, dw = next(iter(batch.values())).shape[0], parallel.data_world()
    if n % dw:
        return batch, True
    return shard(batch, parallel.data_rank(), dw), False


def gradchecks() -> dict:
    """torch.autograd.gradcheck, float64, of the model axis's gathers on
    this rank. Every rank perturbs the same input in step with the others,
    so each path starts from a replicated input: through sum_cotangent (its
    gradient whole on every rank) and shard_rows to this rank's chunk of
    2 * MODEL + 1 rows, which the model ranks split unequally. Then
    gather_patches alone (the identity), and the token path as the trunk
    composes it (gather_tokens, a map that mixes every row into every row as
    attention does, shard_rows, gather_patches); and, as a witness, that
    path with gather_patches in place of gather_tokens, whose gradient lacks
    the other ranks' parts."""
    from omnifusion_torch.parallel import model_axis as ma

    n = 2 * parallel.model_world() + 1
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((n, 3)))
    mix = torch.from_numpy(rng.standard_normal((n, n)))

    def local(t):
        return ma.shard_rows(ma.sum_cotangent(t))

    def path(gather):
        return lambda t: ma.gather_patches(ma.shard_rows(mix @ gather(local(t), n)), n)

    def check(fn, **kw):
        return torch.autograd.gradcheck(fn, (x.clone().requires_grad_(),), **kw)

    return {"chunks": ma.row_chunks(n),
            "gather_patches": check(lambda t: ma.gather_patches(local(t), n)),
            "gather_tokens": check(path(ma.gather_tokens)),
            "tokens_without_the_sum": check(path(ma.gather_patches), raise_exception=False)}


def reform(workdir: str, mesh: parallel.Mesh) -> bool:
    """Take this rank's process group down and bring up one on ``mesh``
    over the first ``mesh.data * mesh.model`` ranks; returns whether this
    rank is in it."""
    import torch.distributed as dist

    rank, n = parallel.rank(), mesh.data * mesh.model
    parallel.destroy()
    if rank >= n:
        return False
    store = dist.FileStore(os.path.join(workdir, f"store_{mesh.data}x{mesh.model}"), n)
    parallel.init_process_group(rank, n, "cpu", "gloo", store=store, mesh=mesh)
    return True


def run_model_axis(workdir: str) -> dict:
    """Every check of tests/test_torch_port_model_axis.py on MODEL_MESH's
    four ranks, then on the same processes as data 1 x model 4 and as data
    1 x model 2 (ranks 0 and 1). The weights come from ``workdir/init.pt``."""
    from omnifusion_torch.parallel.model_axis import row_chunks

    torch.set_num_threads(1)
    init = torch.load(os.path.join(workdir, "init.pt"), weights_only=True)
    out = {"rank": parallel.rank(), "mesh": parallel.current_mesh().shape,
           "data_rank": parallel.data_rank(), "model_rank": parallel.model_rank()}
    part, _ = data_part(depth_batch(0))
    out["oneshot_f64"] = step("oneshot", init["oneshot"], part)
    out["oneshot_f32"] = step("oneshot", init["oneshot"], part, torch.float32)
    out["iterative_f64"] = step("iterative", init["iterative"], part, confidence=False)
    out["seg_f64"] = step("seg", init["seg"], data_part(seg_batch(1))[0])
    whole, held_whole = data_part(seg_batch(1, b=3))
    out["seg_whole"] = {"held_whole": held_whole,
                        **step("seg", init["seg"], whole, whole=held_whole)}
    out["seg_as_shard"] = step("seg", init["seg"], whole)
    out["eval"] = model_axis_eval(workdir, f"eval_{parallel.rank()}")
    out["train"] = model_axis_train(workdir, f"train_{parallel.rank()}")
    out["gradcheck"] = gradchecks()
    out["loader"] = model_axis_loader(workdir)
    reform(workdir, parallel.Mesh(1, 4))
    out["unequal"] = {"chunks": row_chunks(18), "gradcheck": gradchecks(),
                      "oneshot_f64": step("oneshot", init["oneshot"], depth_batch(0, b=1))}
    if reform(workdir, parallel.Mesh(1, 2)):
        out["remat"] = {"remat": step("oneshot", init["oneshot"], depth_batch(0), remat=True),
                        "plain": step("oneshot", init["oneshot"], depth_batch(0))}
    return out


class SmallStanford(StanfordDataset):
    """The Stanford2D3D reader at the tests' panorama size."""

    pano_h, pano_w = ERP


def write_stanford_split(root: str, n: int) -> str:
    """``n`` panoramas in the Stanford2D3D format (8-bit RGB PNG, 16-bit
    depth PNG of depth * 65535 / 128) under ``root``, and their split file."""
    import cv2

    rng = np.random.default_rng(21)
    rows = []
    for i in range(n):
        rgb = rng.integers(0, 256, (*ERP, 3), dtype=np.uint8)
        depth = rng.uniform(0.5, 7.5, ERP) * 65535 / 128
        cv2.imwrite(os.path.join(root, f"pano{i}_rgb.png"), rgb)
        cv2.imwrite(os.path.join(root, f"pano{i}_depth.png"), depth.astype(np.uint16))
        rows.append(f"/pano{i}_rgb.png /pano{i}_depth.png")
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        f.write("\n".join(rows) + "\n")
    return split


MODEL_AXIS_LOADER = dict(n=8, batch=4, epochs=2, workers=4)


def model_axis_loader(workdir: str, device: str = "cpu") -> dict:
    """Two epochs of a shuffled loader over ``workdir/split.txt`` with every
    augmentation on and four worker threads, as cli.train builds it, but
    with the dataset seeded by the global rank, so that ranks that load on
    their own draw different augmentations whatever order the workers take:
    each batch's digest and its samples' depth sums through
    ``to_device(device)`` (what the model ranks train on), and the digests
    of this rank's own loads, the witness."""
    import hashlib

    c = MODEL_AXIS_LOADER
    loader = DataLoader(
        SmallStanford(workdir, os.path.join(workdir, "split.txt"), rotate=True, flip=True,
                      permute_color=True, gamma=True, seed=parallel.rank()),
        c["batch"], shuffle=True, num_workers=c["workers"], seed=3,
        rank=parallel.data_rank(), world=parallel.data_world())

    def digest(b):
        h = hashlib.sha1()
        for k in sorted(b):
            h.update(np.ascontiguousarray(b[k]).tobytes())
        return h.hexdigest()

    shared = [{k: t.cpu() for k, t in b.items()} | {"sharded": b.sharded}
              for _ in range(c["epochs"]) for b in loader.to_device(device)]
    own = [digest(b) for _ in range(c["epochs"]) for b in loader]
    return {"digests": [digest({k: b[k].numpy() for k in ("rgb", "depth", "mask")})
                        for b in shared],
            "sharded": [b["sharded"] for b in shared],
            "depth_sums": [b["depth"].double().sum(dim=(1, 2, 3)).tolist() for b in shared],
            "own_digests": own}


def model_axis_eval(workdir: str, name: str) -> dict:
    """cli.test's run_eval over 3 synthetic panoramas at batch 2 on the
    group's mesh (``--mesh DATA,MODEL``; no mesh outside a group), from
    ``workdir/tamed.pt``: a batch split over the data axis, then one every
    data group runs whole."""
    from omnifusion_torch.cli import test as test_cli

    mesh = parallel.current_mesh()
    spec = f"{mesh.data},{mesh.model}" if mesh is not None else "none"
    return test_cli.run_eval(cli_args(
        ["--synthetic_size", "3", "--batch", "2", "--mesh", spec, "--checkpoint",
         os.path.join(workdir, "tamed.pt"), "--visualize_interval", "0", "--save_path",
         os.path.join(workdir, name)]))


def model_axis_train(workdir: str, name: str) -> dict:
    """cli.train over 2 synthetic panoramas at batch 2 for one epoch (one
    step and a validation) on the group's mesh (no mesh outside a group),
    from ``workdir/tamed.pt``: the history and, on rank 0, what
    read_checkpoint holds of the latest checkpoint; rank 0 then removes the
    checkpoints (each about 0.3 GB)."""
    import shutil

    from omnifusion_torch.cli import train as train_cli

    mesh = parallel.current_mesh()
    spec = f"{mesh.data},{mesh.model}" if mesh is not None else "none"
    ckpt = os.path.join(workdir, name, "ckpt")
    hist = train_cli.run_training(cli_args(
        ["--batch", "2", "--synthetic_size", "2", "--workers", "1", "--epochs", "1",
         "--mesh", spec, "--checkpoint", os.path.join(workdir, "tamed.pt"),
         "--visualize_interval", "0", "--save_path",
         os.path.join(workdir, name), "--save_checkpoint", ckpt], train=True))
    out = {k: hist[k] for k in ("steps", "train_loss", "val")}
    if parallel.rank() == 0:
        out["latest"] = read_checkpoint(os.path.join(ckpt, "latest.pt"))
        shutil.rmtree(ckpt)
    return out
