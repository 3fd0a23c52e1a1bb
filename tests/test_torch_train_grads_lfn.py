"""LiteFlowNet's training held against the JAX package on the CPU (64x64,
B=2): ``train_flow``'s coarse-to-fine loss and every parameter's gradient
(the photometric difference of each Regularization passes none, as the
reference's ``stop_gradient``), ``return_pyramid``'s levels 6..2, the
trainer's init and its 1.55 rescale.  The recipe, the reference and the
tolerances are ``_torch_train.py``'s; the JAX reference is computed once.
"""
import numpy as np
import pytest
import torch

import opticalflowcontainer_tpu.models as jmodels
from _torch_train import (FLOW_REL, check_gradients, check_init_statistics,
                          check_rescale, jax_batch, jax_init, jax_pyramid_loss,
                          jax_reference, port_model)
from opticalflowcontainer_tpu.tools import train_flow as jtrain
from opticalflowcontainer_tpu_torch.parallel.train import batch_to_device
from test_torch_threads import one_torch_thread  # noqa: F401

NAME = "liteflownet"
LEVELS = {"pwcnet": [2, 3, 4, 5, 6], "liteflownet": [2, 3, 4, 5, 6],
          "liteflownet3": [3, 4, 5, 6]}[NAME]


@pytest.fixture(scope="module")
def family():
    """(JAX model, init params, rescaled params, batch, reference), once."""
    model, plain = jax_init(jmodels.LiteFlowNet, 64, 64)
    params = jtrain._kaiming_rescale(plain)
    batch = jax_batch(1, 2, 64, 64)
    ref = jax_reference(model, jax_pyramid_loss(model, batch), params)
    return model, plain, params, batch, ref


def test_training_loss_and_gradients_match_jax(family):
    _, _, params, batch, ref = family
    check_gradients(NAME, ref, params, batch)


def test_return_pyramid_matches_jax(family):
    """``return_pyramid``: the same levels, each flow [B, 2, h, w] equal to
    the reference's per-sample [h, w, 2]; the output is the finest level
    times 20."""
    _, _, params, batch, ref = family
    model = port_model(NAME, params)
    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        out, pyr = model(b["img1"], b["img2"], return_pyramid=True)
    want = ref[2]
    assert sorted(pyr) == sorted(want) == LEVELS
    for lvl, fl in pyr.items():
        w = np.asarray(want[lvl]).transpose(0, 3, 1, 2)
        assert fl.shape == w.shape
        np.testing.assert_allclose(fl.numpy(), w, rtol=0, atol=FLOW_REL * np.abs(w).max())
    torch.testing.assert_close(out, pyr[min(LEVELS)] * 20.0, rtol=0, atol=0)


def test_trainer_init_statistics(family):
    check_init_statistics(NAME, family[2], rescale=True)


def test_kaiming_rescale_matches_jax(family):
    check_rescale(NAME, family[1])
