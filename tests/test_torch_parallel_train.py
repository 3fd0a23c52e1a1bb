"""The port's ``make_sharded_train_step`` against the JAX package's on the
CPU, and against the port's own unsharded ``train_step``.

RAFT-small at 64x64, B=4, ``iters=2``, two steps, from the reference's
``make_train_state`` parameters (jitted init) converted into the port.
JAX runs its sharded step on ``make_mesh(4, data=2, model=2)`` (the
batch on ``data``, the height on ``model``); the port runs its step on 4
spawned gloo ranks (``parallel/dryrun.py``'s ``train`` task), the same
2x2 mesh with ``shard_spatial``, a 4x1 mesh, and the 2x2 mesh without
``shard_spatial``; every step is clipped (below).

Bars, ``tests/_torch_train.py``'s and ``test_torch_train_flow.py``'s:

- the first loss within 1e-5 of the reference's (same parameters), the
  second within 1e-3 (it starts from parameters that differ by Adam's
  sign noise, below);
- the parameters after the first update within 1e-6 where the gradient
  is above 1e-3 of the model's largest: Adam's first update is lr times
  the gradient's sign, and where the gradient is within rounding of 0
  the sign is noise;
- the same bars against the port's unsharded step on the whole batch.

The clip: at this init the gradient's norm is ~40 times the reference's
clip of 1.0, so every step here is clipped.  The sharded step (the
gradients averaged over ``data``, then clipped) equals the unsharded
step; clipping each rank's gradient before the average weights the ranks
by their norms and flips the sign of some of Adam's first updates (a
change of 2 lr, far above the 1e-6 bar).  A clip far below the norm
would not test more: it scales the gradients to Adam's epsilon, where
the update follows the rounding of the gradients' small entries.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import opticalflowcontainer_tpu.models as jmodels
from _torch_train import flat, jax_batch, jax_init, port_model
from opticalflowcontainer_tpu.parallel import make_mesh as jmake_mesh
from opticalflowcontainer_tpu.parallel import train as jptrain
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.parallel import dryrun
from test_torch_threads import one_torch_thread  # noqa: F401

B, H, W, ITERS = 4, 64, 64, 2
# (mesh, shard_spatial) of the port's runs: the reference's 2x2 with the
# height on model, 4x1, and 2x2 with the batch rows alone on data (each
# model group's ranks then compute the same rows)
RUNS = [((2, 2), True), ((4, 1), True), ((2, 2), False)]
IDS = ["2x2_spatial", "4x1", "2x2_rows"]
CLIP = 1.0  # the reference's clip: ~40x below the gradient's norm here


@pytest.fixture(scope="module")
def setup():
    model, params = jax_init(jmodels.RAFTSmall, H, W, ITERS)
    tmodel = port_model("raft_small", params)
    state = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    batches = [jax_batch(seed, B, H, W) for seed in (3, 4)]
    return model, params, tmodel, state, batches


@pytest.fixture(scope="module")
def jax_run(setup):
    """The reference's sharded step, two steps: losses and flat params."""
    model, params, _, _, batches = setup
    tx = jptrain.make_optimizer(4e-4)
    jstate = jptrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jptrain.make_sharded_train_step(model, tx, jmake_mesh(4, data=2, model=2),
                                           iters=ITERS)
    losses, flats = [], []
    for b in batches:
        jstate, loss = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
        # copies: the next step donates the state's buffers
        flats.append({k: np.array(v, copy=True) for k, v in flat(jstate.params).items()})
    return losses, flats


@pytest.fixture(scope="module")
def port(setup):
    """The two runs on one spawn of 4 gloo ranks."""
    _, _, _, state, batches = setup
    runs = [dict(mesh=mesh, state=state, batches=batches, iters=ITERS,
                 shard_spatial=spatial) for mesh, spatial in RUNS]
    return dryrun.spawn(4, "train", {"runs": runs}, cpu=True, timeout_s=600)


def _update_gap(got: dict, want: dict, grads: dict) -> float:
    """Largest |got - want| over the parameters whose gradient is above
    1e-3 of the model's largest."""
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    gap = 0.0
    for name, g in grads.items():
        mask = np.abs(g) > 1e-3 * gmax
        if mask.any():
            gap = max(gap, float(np.abs(got[name] - want[name])[mask].max()))
    return gap


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("run", range(len(RUNS)), ids=IDS)
def test_every_rank_returns_the_global_mean_loss(port, run):
    losses = [rank[run]["losses"] for rank in port]
    assert all(np.isfinite(losses[0])) and len(losses[0]) == 2
    assert all(other == losses[0] for other in losses[1:])


def test_sharded_step_matches_jax(port, jax_run, setup):
    _, _, tmodel, _, _ = setup
    got = port[0][0]
    jlosses, jflats = jax_run
    assert _rel(got["losses"][0], jlosses[0]) <= 1e-5
    assert _rel(got["losses"][1], jlosses[1]) <= 1e-3
    want = {k: v.numpy() for k, v in
            convert.flax_to_torch_state_dict(jflats[0], tmodel).items()}
    assert _update_gap(got["params"][0], want, got["grads"][0]) <= 1e-6


@pytest.mark.parametrize("run", range(len(RUNS)), ids=IDS)
def test_sharded_step_matches_the_unsharded_step(port, run):
    got = port[0][run]
    assert _rel(got["losses"][0], got["plain_losses"][0]) <= 1e-5
    assert _rel(got["losses"][1], got["plain_losses"][1]) <= 1e-3
    assert _update_gap(got["params"][0], got["plain_params"][0],
                       got["grads"][0]) <= 1e-6


def test_the_clip_binds_and_acts_on_the_averaged_gradient(port):
    """On every run the gradient's global norm is far above the clip, and
    the averaged gradient the step clipped is the unsharded step's (the
    norm of the rank-0 copy of the averaged gradient equals the unsharded
    norm)."""
    for got in port[0]:
        norm = got["plain_grad_norms"][0]
        assert norm > 10 * CLIP
        averaged = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                               for g in got["grads"][0].values()))
        assert averaged == pytest.approx(norm, rel=1e-4)
