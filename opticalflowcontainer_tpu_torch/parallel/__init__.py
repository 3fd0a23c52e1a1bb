"""Training (the port's copy of the reference's ``parallel`` package):
``train`` (the optax recipe written out, :class:`~.train.TrainState`,
RAFT's :func:`~.train.train_step`) and ``checkpoint`` (train-state
checkpoints on ``torch.save``).  The mesh, the sharded steps and sharded
inference wait for the port's ``torch.distributed`` slice."""
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .train import (AdamW, TrainState, make_optimizer, make_train_state,
                    sequence_loss, train_step, warmup_cosine_decay)

__all__ = [
    "AdamW",
    "TrainState",
    "latest_checkpoint",
    "make_optimizer",
    "make_train_state",
    "restore_checkpoint",
    "save_checkpoint",
    "sequence_loss",
    "train_step",
    "warmup_cosine_decay",
]
