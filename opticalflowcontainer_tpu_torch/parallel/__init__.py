"""Training and scale-out (the port's copy of the reference's ``parallel``
package) on ``torch.distributed``:

- ``mesh``: the ``("data", "model")`` :func:`~.mesh.make_mesh` (the JAX
  grid's row-major rank layout), the placements :func:`~.mesh.batch_sharding`
  and :func:`~.mesh.replicated`, :func:`~.mesh.local_shard` and
  :func:`~.mesh.init_distributed`;
- ``infer``: the sharded flow, stream and spatial callables, each taking
  and returning this rank's block;
- ``train``: the optax recipe written out, :class:`~.train.TrainState`,
  RAFT's :func:`~.train.train_step` and :func:`~.train.make_sharded_train_step`;
- ``checkpoint``: train-state checkpoints on ``torch.save``;
- ``dryrun``: the multi-rank dry run and the rank worker
  (``python -m opticalflowcontainer_tpu_torch.parallel.dryrun``).
"""
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .infer import (make_sharded_flow_fn, make_sharded_stream_fn,
                    make_spatial_sharded_flow_fn)
from .mesh import (batch_sharding, init_distributed, local_shard, make_mesh,
                   replicated)
from .train import (AdamW, TrainState, make_optimizer, make_sharded_train_step,
                    make_train_state, sequence_loss, train_step,
                    warmup_cosine_decay)

__all__ = [
    "AdamW",
    "TrainState",
    "batch_sharding",
    "init_distributed",
    "latest_checkpoint",
    "local_shard",
    "make_mesh",
    "make_optimizer",
    "make_sharded_flow_fn",
    "make_sharded_stream_fn",
    "make_sharded_train_step",
    "make_spatial_sharded_flow_fn",
    "make_train_state",
    "replicated",
    "restore_checkpoint",
    "save_checkpoint",
    "sequence_loss",
    "train_step",
    "warmup_cosine_decay",
]
