"""RAFT-small's training held against the JAX package on the CPU (32x32,
B=2, 2 iterations): the sequence loss of every iteration's flow (the
reference's ``parallel/train.py`` ``train_step`` loss) and every
parameter's gradient, through the correlation lookup's coordinates as in
the reference (neither side stops a gradient there), and the trainer's
init.  The reference, the checks and the tolerances are
``_torch_train.py``'s; the JAX reference is computed once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowcontainer_tpu.models as jmodels
from _torch_train import (FLOW_REL, check_gradients, check_init_statistics,
                          jax_batch, jax_init, jax_reference, port_model)
from opticalflowcontainer_tpu.parallel.train import sequence_loss as jsequence_loss
from opticalflowcontainer_tpu_torch.parallel.train import batch_to_device, sequence_loss
from test_torch_threads import one_torch_thread  # noqa: F401

ITERS = 2


def jax_raft_loss(model, batch):
    """The reference's ``train_step`` loss, with the stacked flows as aux."""
    def loss_fn(params):
        def one(i1, i2, gt):
            flows = model.apply(params, i1, i2, ITERS)
            return jsequence_loss(flows, gt), flows

        losses, flows = jax.vmap(one)(batch["img1"], batch["img2"], batch["flow"])
        return jnp.mean(losses), flows
    return loss_fn


@pytest.fixture(scope="module")
def family():
    model, params = jax_init(jmodels.RAFTSmall, 32, 32, 2)
    batch = jax_batch(3, 2, 32, 32)
    return params, batch, jax_reference(model, jax_raft_loss(model, batch), params)


def test_training_loss_and_gradients_match_jax(family):
    params, batch, ref = family
    check_gradients("raft_small", ref, params, batch, loss_fn=lambda m, b: sequence_loss(
        m(b["img1"], b["img2"], ITERS), b["flow"]))


def test_every_iteration_flow_matches_jax(family):
    """The stacked flows [iters, B, 2, H, W] the sequence loss reads equal
    the reference's [B, iters, H, W, 2]."""
    params, batch, ref = family
    model = port_model("raft_small", params)
    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        flows = model(b["img1"], b["img2"], ITERS)
    want = np.asarray(ref[2]).transpose(1, 0, 4, 2, 3)
    assert flows.shape == want.shape
    np.testing.assert_allclose(flows.numpy(), want, rtol=0, atol=FLOW_REL * np.abs(want).max())


def test_sequence_loss_matches_jax(rng):
    """The port's batched sequence loss == the mean over samples of the
    reference's per-sample one (fp32, 1e-6 relative)."""
    flows = rng.normal(size=(3, 2, 16, 24, 2)).astype(np.float32)
    gt = rng.normal(size=(2, 16, 24, 2)).astype(np.float32)
    want = float(np.mean([jsequence_loss(jnp.asarray(flows[:, i]), jnp.asarray(gt[i]))
                          for i in range(2)]))
    got = float(sequence_loss(torch.from_numpy(flows).permute(0, 1, 4, 2, 3),
                              torch.from_numpy(gt).permute(0, 3, 1, 2)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_trainer_init_statistics(family):
    check_init_statistics("raft_small", family[0], rescale=False)
