"""K4's plain version (``ops/correlation.py``) held against the JAX
package's ``correlation_lax`` in every configuration of the model zoo, and
against the Pallas kernel in interpret mode where it applies (out_stride 1),
on the CPU.  The CUDA kernel is held against the same plain version on the
card (tests/test_torch_gpu.py, chip_smoke.py).  Inputs are made with numpy
from a seed; the JAX side is NHWC, the port NCHW.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.ops import correlation_lax
from opticalflowcontainer_tpu.ops.correlation_pallas import correlation_pallas
from opticalflowcontainer_tpu_torch.ops import correlation as k4

# (max_disp, disp_stride, out_stride) of every user, ops/correlation.py
CONFIGS = {
    "pwc": (4, 1, 1),
    "lfn_levels4to6": (3, 1, 1),
    "lfn_levels2to3": (6, 2, 2),
    "lfn3_cross": (4, 1, 1),
    "lfn3_self_level4": (6, 2, 1),
    "lfn3_self_level3": (8, 2, 1),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_matches_correlation_lax(name, rng):
    """Odd sizes (13 x 17) so the strided output's ragged edge is covered.
    Tolerance 1e-6 of max|f1| max|f2|: each output is a mean of 8 fp32
    products, summed in another order on the two sides."""
    max_disp, ds, os_ = CONFIGS[name]
    f1 = rng.standard_normal((2, 13, 17, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 13, 17, 8)).astype(np.float32)
    want = np.asarray(correlation_lax(f1, f2, max_disp, ds, os_))
    before = k4.local_correlation.launches
    got = k4.local_correlation(_nchw(f1), _nchw(f2), max_disp, ds, os_)
    assert k4.local_correlation.launches == before  # CPU tensors: plain version
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(f1).max() * np.abs(f2).max())


@pytest.mark.parametrize("name", sorted(n for n, c in CONFIGS.items() if c[2] == 1))
def test_plain_matches_pallas_interpret(name, rng):
    """The Pallas kernel (interpret mode on the CPU, as
    tests/test_ops_correlation.py runs it) on 24 channels.  Tolerance as
    above, for 24 products."""
    max_disp, ds, _ = CONFIGS[name]
    f1 = rng.standard_normal((12, 16, 24)).astype(np.float32)
    f2 = rng.standard_normal((12, 16, 24)).astype(np.float32)
    want = np.asarray(correlation_pallas(f1, f2, max_disp, ds, 1))
    got = k4.correlation_plain(_nchw(f1)[None], _nchw(f2)[None], max_disp, ds, 1)
    np.testing.assert_allclose(got[0].numpy().transpose(1, 2, 0), want, rtol=0,
                               atol=1e-6 * np.abs(f1).max() * np.abs(f2).max())


def test_plain_gradient_matches_jax(rng):
    """On the CPU the plain version is differentiable by autograd: its
    gradients of sum(out^2) == JAX's of correlation_lax.  Tolerance 1e-5
    of the gradient's scale (fp32 sums in another order)."""
    f1 = rng.standard_normal((6, 7, 4)).astype(np.float32)
    f2 = rng.standard_normal((6, 7, 4)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(correlation_lax(a, b, 2) ** 2),
                    argnums=(0, 1))(f1, f2)
    t1 = _nchw(f1)[None].requires_grad_()
    t2 = _nchw(f2)[None].requires_grad_()
    (k4.local_correlation(t1, t2, 2) ** 2).sum().backward()
    for t, w in zip((t1, t2), want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad[0].numpy().transpose(1, 2, 0), w,
                                   rtol=0, atol=1e-5 * np.abs(w).max())


def test_correlation_wrapper_checks_its_inputs():
    f = torch.zeros(1, 4, 6, 7)
    with pytest.raises(ValueError, match="multiple"):
        k4.local_correlation(f, f, 3, 2)
    with pytest.raises(ValueError, match="f2"):
        k4.local_correlation(f, f[..., :6], 4)
    with pytest.raises(TypeError, match="float32"):
        k4.local_correlation(f.double(), f.double(), 4)
