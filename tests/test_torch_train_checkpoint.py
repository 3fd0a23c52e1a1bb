"""The port's train-state checkpoints (``parallel/checkpoint.py``): save,
latest and restore round-trip; an interrupted save's temporary entry is
never picked (the reference's exact-name rule); and a run stopped at step
4 and resumed from its checkpoint reaches step 8 with the params, the
optimizer's moments and its count of a run that never stopped, bit for
bit on the CPU.  Only the port is involved.
"""
import os

import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu_torch.models.common import flax_init
from opticalflowcontainer_tpu_torch.parallel import checkpoint
from opticalflowcontainer_tpu_torch.parallel.train import (TrainState, batch_to_device,
                                                           descend, make_optimizer,
                                                           warmup_cosine_decay)
from opticalflowcontainer_tpu_torch.tools import train_flow as ttrain
from test_torch_threads import one_torch_thread  # noqa: F401


def _state(seed=0) -> TrainState:
    """NeuFlowLite from the trainer's init with train_flow's optimizer on a
    warm-up cosine schedule of 8 steps."""
    model = flax_init(ttrain.build_model("neuflow_lite"), torch.Generator().manual_seed(seed))
    sched = warmup_cosine_decay(0.0, 1e-3, 2, 8, 2e-5)
    return TrainState(model, make_optimizer(dict(model.named_parameters()), sched))


def _batches(n=8):
    rng = np.random.default_rng(5)
    return [batch_to_device(ttrain.make_affine_batch(rng, 2, 32, 32), "cpu") for _ in range(n)]


def _run(state, batches):
    loss_fn = ttrain.make_loss("neuflow_lite")
    for b in batches:
        descend(state, loss_fn(state.model, b))
    return state


def _equal(a: TrainState, b: TrainState) -> bool:
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (a.step == b.step and sa["count"] == sb["count"]
            and all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                        b.model.state_dict().values()))
            and all(torch.equal(sa[m][k], sb[m][k]) for m in ("mu", "nu") for k in sa[m]))


def test_save_latest_restore_round_trip(tmp_path):
    state = _run(_state(), _batches(2))
    path = checkpoint.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000002"
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
    fresh = _state(seed=1)
    assert not _equal(fresh, state)
    assert checkpoint.restore_checkpoint(str(tmp_path), fresh) is fresh
    assert _equal(fresh, state)
    assert checkpoint.restore_checkpoint(str(tmp_path / "none"), _state()) is None
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


def test_latest_never_picks_an_interrupted_save(tmp_path):
    """A save writes ``step_XXXXXXXX.tmp-<pid>`` and renames it: a leftover
    temporary (or any other name) is skipped, even where it sorts after
    the newest complete checkpoint."""
    state = _run(_state(), _batches(1))
    done = checkpoint.save_checkpoint(str(tmp_path), state, step=4)
    for name in ("step_00000008.tmp-1234", "step_00000009.orbax-checkpoint-tmp-1",
                 "step_0000010", "step_000000011"):
        (tmp_path / name).write_bytes(b"partial")
    assert checkpoint.latest_checkpoint(str(tmp_path)) == done
    assert len(os.listdir(tmp_path)) == 5


def test_resume_from_step_4_equals_an_unbroken_run(tmp_path):
    batches = _batches()
    unbroken = _run(_state(), batches)
    first = _run(_state(), batches[:4])
    checkpoint.save_checkpoint(str(tmp_path), first)
    resumed = checkpoint.restore_checkpoint(str(tmp_path), _state(seed=3))
    assert resumed.step == 4 and resumed.optimizer.count == 4
    _run(resumed, batches[4:])
    assert _equal(resumed, unbroken)


def test_restore_refuses_another_models_optimizer_state(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path), _run(_state(), _batches(1)))
    model = flax_init(ttrain.build_model("raft_small"), torch.Generator().manual_seed(0))
    other = TrainState(model, make_optimizer(dict(model.named_parameters())))
    with pytest.raises((RuntimeError, ValueError)):
        checkpoint.restore_checkpoint(str(tmp_path), other)
