from omnifusion_torch.training.checkpoint import CheckpointManager, restore_file
from omnifusion_torch.training.schedule import CosineWarmRestarts, cosine_warm_restarts
from omnifusion_torch.training.trainer import (
    TrainState,
    create_train_state,
    eval_step,
    forward_loss,
    make_optimizer,
    param_groups,
    train_step,
)

__all__ = [
    "CheckpointManager",
    "CosineWarmRestarts",
    "TrainState",
    "cosine_warm_restarts",
    "create_train_state",
    "eval_step",
    "forward_loss",
    "make_optimizer",
    "param_groups",
    "restore_file",
    "train_step",
]
