"""NeuFlowLite's and NeuFlow-v2's training held against the JAX package on
the CPU (48x64, B=2, one refinement iteration): ``train_flow``'s loss
(final + 0.3 of the matching stage's flow, ``return_aux``) and every
parameter's gradient, the final and the aux flows, and the trainer's init
(flax's distribution per weight; LayerNorm scale 1, NeuFlowLite's
temperature 10 and gate 0 exactly).  The reference, the checks and the
tolerances are ``_torch_train.py``'s; each JAX reference is computed once.
"""
import functools

import numpy as np
import pytest
import torch

import opticalflowcontainer_tpu.models as jmodels
from _torch_train import (FLOW_REL, check_gradients, check_init_statistics,
                          jax_aux_loss, jax_batch, jax_init, jax_reference)
from opticalflowcontainer_tpu_torch.models import NeuFlowLite, convert
from opticalflowcontainer_tpu_torch.parallel.train import batch_to_device
from opticalflowcontainer_tpu_torch.tools import train_flow as ttrain
from test_torch_threads import one_torch_thread  # noqa: F401

H, W = 48, 64
JAX_LITE = functools.partial(jmodels.NeuFlowLite, iters=1)


@pytest.fixture(scope="module", params=["neuflow_lite", "neuflow_v2"])
def family(request):
    """(name, params, batch, reference, port model, port loss), once."""
    name = request.param
    batch = jax_batch(4, 2, H, W)
    if name == "neuflow_lite":
        jmodel, params = jax_init(JAX_LITE, H, W)
        ref = jax_reference(jmodel, jax_aux_loss(jmodel, batch), params)
        model, loss_fn = NeuFlowLite(iters=1), ttrain.make_loss(name)
    else:
        jmodel, params = jax_init(jmodels.NeuFlowV2, H, W, 1)
        ref = jax_reference(jmodel, jax_aux_loss(jmodel, batch, 1), params)
        model, loss_fn = ttrain.build_model(name), ttrain.make_loss(name, iters=1)
    from _torch_train import flat

    model.load_state_dict(convert.flax_to_torch_state_dict(flat(params), model))
    return name, params, batch, ref, model, loss_fn


def test_training_loss_and_gradients_match_jax(family):
    name, params, batch, ref, model, loss_fn = family
    check_gradients(name, ref, params, batch, model=model, loss_fn=loss_fn)


def test_return_aux_matches_jax(family):
    """``return_aux``: the final flow and the matching stage's flow
    upsampled to the input, [B, 2, H, W] against the reference's
    per-sample [H, W, 2]."""
    name, _, batch, ref, model, _ = family
    b = batch_to_device(batch, "cpu")
    kwargs = {"iters_s8": 1} if name == "neuflow_v2" else {}
    with torch.no_grad():
        out, aux = model(b["img1"], b["img2"], return_aux=True, **kwargs)
        plain = model(b["img1"], b["img2"], **kwargs)
    for got, want in zip((out, aux), ref[2]):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FLOW_REL * np.abs(want).max())
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_trainer_init_statistics(family):
    check_init_statistics(family[0], family[1], rescale=False)
