"""Train and eval steps.

The port's counterpart of ``omnifusion_tpu/training/trainer.py``, with the
reference training recipe (train_erp_depth.py:156-294): AdamW (lr 1e-4,
weight decay 0.01) under per-step cosine warm restarts, BerHu supervision,
BatchNorm running statistics updated once per train forward.

``TrainState`` holds the model, the optimizer, the schedule and the update
count; ``train_step`` updates all of them in place, where the JAX package
returns a new state. torch's AdamW and optax's adamw agree on the update:
bias-corrected moments, eps outside the square root, decoupled decay
``lr * wd * p``. The schedule is evaluated at the update count before the
increment, as optax evaluates it.

Under data parallelism ``state.model`` is the DistributedDataParallel wrap
(parallel/ddp.py) and each rank steps on its shard of the global batch:
the gradients, and so the gradient norm, are the ranks' average when the
backward returns, and the loss reported is the mean of the ranks' losses,
which is the global batch's (losses/direct.py, models/segmentation.py).
``eval_step`` runs the bare module; on a batch split over ranks it scores
the prediction of the global batch, gathered, as the JAX eval step's median
scaling is over the sharded batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn

from omnifusion_torch.evaluation.metrics import compute_depth_metrics
from omnifusion_torch.losses.direct import berhu_loss
from omnifusion_torch.models.segmentation import cross_entropy_ignore
from omnifusion_torch.parallel.ddp import unwrap
from omnifusion_torch.parallel.mesh import all_gather_cat, mean_over_ranks
from omnifusion_torch.parallel.sync_bn import replicated_batch
from omnifusion_torch.training.schedule import cosine_warm_restarts


def param_groups(
    model: nn.Module, weight_decay: float, caffe_bias_rules: bool = False,
    frozen_prefixes: tuple = (),
) -> list[dict]:
    """The optimizer's parameter groups, each with an ``lr_scale`` on the
    schedule (trainer.py:44-92 of the JAX package).

    ``caffe_bias_rules`` (upstream util.py:147-155): parameters whose last
    name part contains "bias" get twice the learning rate and no weight
    decay. ``frozen_prefixes`` (upstream util.py:124-130): parameters whose
    name starts with a prefix get no updates; they still get gradients, as
    the JAX package's do."""
    groups = {"other": [], "bias": []}
    for name, p in model.named_parameters():
        if any(name.startswith(pre) for pre in frozen_prefixes):
            continue
        bias = caffe_bias_rules and "bias" in name.rsplit(".", 1)[-1]
        groups["bias" if bias else "other"].append(p)
    out = [{"params": groups["other"], "weight_decay": weight_decay, "lr_scale": 1.0}]
    if groups["bias"]:
        out.append({"params": groups["bias"], "weight_decay": 0.0, "lr_scale": 2.0})
    return out


def make_optimizer(
    model: nn.Module,
    lr: float = 1e-4,
    weight_decay: float = 0.01,
    caffe_bias_rules: bool = False,
    frozen_prefixes: tuple = (),
) -> torch.optim.AdamW:
    """AdamW over ``param_groups``; the learning rate is set before every
    update from the schedule (``train_step``)."""
    return torch.optim.AdamW(
        param_groups(model, weight_decay, caffe_bias_rules, frozen_prefixes), lr=lr
    )


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(
    model: nn.Module,
    lr: float = 1e-4,
    weight_decay: float = 0.01,
    t_0: int = 5,
    t_mult: int = 2,
    steps_per_epoch: int = 1,
    caffe_bias_rules: bool = False,
    frozen_prefixes: tuple = (),
) -> TrainState:
    return TrainState(
        model=model,
        optimizer=make_optimizer(model, lr, weight_decay, caffe_bias_rules, frozen_prefixes),
        schedule=cosine_warm_restarts(lr, t_0, t_mult, steps_per_epoch=steps_per_epoch),
    )


def forward_loss(
    model: nn.Module, batch: dict, confidence: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Train-mode forward and BerHu loss: (loss, pred). batch: rgb
    (B, H, W, 3), depth and mask (B, H, W, 1). A model that returns a list
    of predictions (the iterative one, a depth per pass) is trained on the
    mean of their losses, and pred is the last pass (trainer.py:107-117 of
    the JAX package)."""
    model.train()
    out = model(batch["rgb"], confidence=confidence)
    preds = out if isinstance(out, (list, tuple)) else [out]
    losses = [berhu_loss(p, batch["depth"], batch["mask"]) for p in preds]
    return torch.stack(losses).mean(), preds[-1]


def _update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Backward of ``loss`` and one AdamW update at the schedule's rate;
    returns the global L2 norm of all the gradients."""
    loss.backward()
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr * group["lr_scale"]
    state.optimizer.step()
    state.step += 1
    return grad_norm


def train_step(state: TrainState, batch: dict, confidence: bool = True) -> dict[str, torch.Tensor]:
    """One update; returns loss, grad_norm (global L2 norm of all the
    gradients) and pred_mean as 0-d tensors on the model's device, so that
    the caller decides when to sync. ``confidence``: the model's merge."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, pred = forward_loss(state.model, batch, confidence)
    grad_norm = _update(state, loss)
    return {"loss": mean_over_ranks(loss.detach()), "grad_norm": grad_norm,
            "pred_mean": pred.detach().mean()}


def seg_forward_loss(model: nn.Module, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Train-mode forward of a segmentation model and its cross-entropy
    over the labels that are not -1: (loss, logits). batch: rgb (B, H, W,
    3), labels (B, H, W) (cli/train_sem.py of the JAX package)."""
    model.train()
    logits = model(batch["rgb"])
    return cross_entropy_ignore(logits, batch["labels"]), logits


def train_step_sem(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
    """One update of a segmentation model; returns loss and grad_norm as
    0-d tensors on the model's device. A ``Batch`` that this rank holds
    whole (``sharded`` false: one the ranks cannot split, which each runs
    whole, as the JAX mesh replicates it) keeps its global BatchNorms on
    this process's statistics and count (parallel.replicated_batch)."""
    state.optimizer.zero_grad(set_to_none=True)
    whole = not getattr(batch, "sharded", True)
    with replicated_batch(unwrap(state.model)) if whole else contextlib.nullcontext():
        loss, _ = seg_forward_loss(state.model, batch)
    grad_norm = _update(state, loss)
    return {"loss": mean_over_ranks(loss.detach()), "grad_norm": grad_norm}


def eval_step(model: nn.Module, batch: dict, confidence: bool = True):
    """Eval-mode forward and the median-scaled depth metrics of its
    prediction, or of its last pass: (metrics, N, pred). On a batch that
    is split over ranks (``batch.sharded``) the metrics and N are the
    global batch's, the same on every rank; pred is this rank's."""
    model = unwrap(model)
    model.eval()
    with torch.inference_mode():
        out = model(batch["rgb"], confidence=confidence)
        pred = out[-1] if isinstance(out, (list, tuple)) else out
        scored = [pred, batch["depth"], batch["mask"]]
        if getattr(batch, "sharded", False):
            scored = [all_gather_cat(t) for t in scored]
        metrics, n = compute_depth_metrics(*scored)
    return metrics, n, pred
