"""Helpers of the training parity tests (``test_torch_train_grads_*.py``):
the reference's training losses written out as its ``tools/train_flow.py``
step computes them (``vmap`` of a per-sample loss, ``jax.value_and_grad``),
and the checks of the port's loss, gradients, outputs and init against
them.

The JAX side runs at ``model.init``'s parameters (times 1.55 for the
coarse-to-fine families, as the trainer inits them); the port loads the
same parameters through ``flax_to_torch_state_dict`` and takes
``train_flow.make_loss``'s loss through autograd (K3 and K4 run their
plain versions on the CPU).  The gradients are mapped through the same
converter (it is linear).  Batches are JAX's ``make_affine_batch`` from a
seed.

Tolerances:

- the loss within 1e-5 of itself;
- the gradients on the model's scale: each tensor's largest difference
  within 1e-4 of the model's largest gradient, and all of them as one
  vector within 1e-3 in L2.  Both frameworks run fp32 with sums in other
  orders, so the forward values differ by ~1e-7; where that moves a leaky
  ReLU across its kink or a warp coordinate across a whole pixel, the
  gradient of that element jumps.  Measured on the CPU: ~1e-6 on both
  measures for PWC-Net and LiteFlowNet; LFN3 2.7e-5 and 1.3e-4, from one
  stage (matching3) on this batch, 3e-6 and 2e-6 on two others.  A wiring
  fault shows above the bars: LiteFlowNet without its stop-gradient on
  the photometric difference gives 1.6e-3 and 2.9e-3;
- each output flow within 1e-4 of its largest entry (measured ~1e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opticalflowcontainer_tpu.core.resize import resize_area as jresize_area
from opticalflowcontainer_tpu.tools import train_flow as jtrain
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models.common import flax_init
from opticalflowcontainer_tpu_torch.parallel.train import batch_to_device
from opticalflowcontainer_tpu_torch.tools import train_flow as ttrain

LOSS_REL, GRAD_REL, GRAD_L2, FLOW_REL = 1e-5, 1e-4, 1e-3, 1e-4
LEVEL_WEIGHTS = {6: 0.32, 5: 0.08, 4: 0.02, 3: 0.01, 2: 0.005}


def flat(tree) -> dict:
    """flax params (or their gradients) as flat ``a/b/c`` keys."""
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in leaves}


def jax_batch(seed: int, B: int, H: int, W: int) -> dict:
    return jtrain.make_affine_batch(np.random.default_rng(seed), B, H, W)


@functools.lru_cache(maxsize=None)
def jax_init(cls, H: int, W: int, *args):
    """(model, ``model.init`` params) of the reference's class ``cls`` at
    an [H, W, 3] input (``args`` passed on), jitted: an eager init of a
    full-width net takes about a minute on the CPU."""
    model = cls()
    i0 = jnp.zeros((H, W, 3), jnp.float32)
    return model, jax.jit(lambda k: model.init(k, i0, i0, *args))(jax.random.PRNGKey(0))


def jax_pyramid_loss(model, batch):
    """The reference's coarse-to-fine step loss (its ``train_flow`` step
    body), with the per-level flows of every sample as aux."""
    def loss_fn(params):
        def one(i1, i2, gt):
            _, pyr = model.apply(params, i1, i2, return_pyramid=True)
            total = 0.0
            for lvl, fl in pyr.items():
                gt_l = jresize_area(gt.transpose(2, 0, 1), fl.shape[:2]).transpose(
                    1, 2, 0) * (1.0 / 20.0)
                total = total + LEVEL_WEIGHTS[lvl] * jnp.abs(fl - gt_l).mean()
            return total, pyr

        losses, pyr = jax.vmap(one)(batch["img1"], batch["img2"], batch["flow"])
        return jnp.mean(losses), pyr
    return loss_fn


def jax_aux_loss(model, batch, *args):
    """The reference's NeuFlow step loss (final + 0.3 aux), with the final
    and the aux flows as aux; ``args`` go to ``apply`` (v2's iters)."""
    def loss_fn(params):
        def one(i1, i2, gt):
            out, aux = model.apply(params, i1, i2, *args, return_aux=True)
            return (jnp.abs(out - gt).mean() + 0.3 * jnp.abs(aux - gt).mean(),
                    (out, aux))

        losses, outs = jax.vmap(one)(batch["img1"], batch["img2"], batch["flow"])
        return jnp.mean(losses), outs
    return loss_fn


def jax_reference(model, loss_fn, params):
    """(loss, flat gradients, aux) of the JAX recipe."""
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), flat(grads), aux


def port_model(name: str, params) -> torch.nn.Module:
    model = ttrain.build_model(name)
    model.load_state_dict(convert.flax_to_torch_state_dict(flat(params), model))
    return model


def grad_gap(got, want) -> tuple[float, float]:
    """(the largest |got - want| of any tensor over the largest |want| of
    the model, |got - want| over |want| as one vector in L2)."""
    scale = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    diff = sum(float((g - w).double().square().sum()) for g, w in zip(got, want))
    norm = sum(float(w.double().square().sum()) for w in want)
    return worst / scale, (diff / norm) ** 0.5


def check_gradients(name, ref, params, batch, model=None, loss_fn=None):
    """The port's loss and gradients of family ``name`` at ``params`` on
    ``batch`` against the JAX reference ``ref``; returns the port's model.
    ``model`` (built from ``params`` by default) and ``loss_fn(model, b)``
    (train_flow's by default) may be given."""
    loss_ref, grads_ref, _ = ref
    model = model or port_model(name, params)
    want = convert.flax_to_torch_state_dict(grads_ref, model)
    loss = (loss_fn or ttrain.make_loss(name))(model, batch_to_device(batch, "cpu"))
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - loss_ref) <= LOSS_REL * abs(loss_ref), (
        float(loss.detach()), loss_ref)
    worst, l2 = grad_gap(got, [want[n] for n in names])
    print(f"{name}: largest gradient difference {worst:.3e} of the largest "
          f"gradient, {l2:.3e} in L2")
    assert worst <= GRAD_REL and l2 <= GRAD_L2, (worst, l2)
    return model


def check_init_statistics(name, jparams, rescale: bool, seed=0):
    """The trainer's init (flax_init, and the 1.55 rescale where the family
    takes it) against the reference's params per parameter: biases and
    constants exactly; each weight's std within 6 standard errors of JAX's
    (two samples of a truncated normal: ~0.9 / sqrt(n) relative); both
    truncated at two of the std flax's variance scaling gives."""
    model = ttrain.build_model(name)
    flax_init(model, torch.Generator().manual_seed(seed))
    if rescale:
        ttrain._kaiming_rescale(model)
    ours = convert.torch_to_flax_flat(model)
    theirs = flat(jparams)
    assert set(ours) == set(theirs)
    gain = 1.55 if rescale else 1.0
    for key, a in ours.items():
        b = theirs[key]
        if not key.endswith("kernel"):
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        n = a.size
        rel = abs(a.std() - b.std()) / b.std()
        assert rel <= 6 * 0.9 / np.sqrt(n), (key, a.std(), b.std(), n)
        fan_in = n // a.shape[-1]
        bound = 2 * gain * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(a).max() <= bound * (1 + 1e-6) and np.abs(b).max() <= bound * (1 + 1e-6)


def check_rescale(name, jparams_plain):
    """``_kaiming_rescale`` equals the reference's on the same params: every
    kernel times 1.55, biases untouched (bit for bit)."""
    model = port_model(name, jparams_plain)
    ttrain._kaiming_rescale(model)
    want = flat(jtrain._kaiming_rescale(jparams_plain))
    got = convert.torch_to_flax_flat(model)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
