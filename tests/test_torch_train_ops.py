"""K3's and K4's backward for training, held against the JAX package on the
CPU.

On the card each wrapper runs its kernel forward inside an
``autograd.Function`` (``WarpFunction``, ``CorrelationFunction``) whose
backward is the autograd of the plain version on the saved inputs, as the
reference's ``correlation_pallas`` is a ``custom_vjp`` whose backward is
``jax.vjp`` of ``correlation_lax``.  Here: the plain versions' gradients
against ``jax.vjp`` of ``correlation_lax`` (all six configurations) and of
the ``core/warp.py`` warps (every convention, PWC-Net's mask away from its
threshold); ``torch.autograd.gradcheck`` in float64 on both; and the two
Functions' plumbing, and K6's ``LookupFunction``'s, with the kernel's
forward stood in for by the plain version (the CUDA kernel itself runs
only on the card: tests/test_torch_gpu.py, chip_smoke.py phase 23).
Inputs are made with numpy from a seed; the JAX side is NHWC, the port
NCHW.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.core import warp as jwarp
from opticalflowcontainer_tpu.ops import correlation_lax
from opticalflowcontainer_tpu_torch.core import warp as twarp
from opticalflowcontainer_tpu_torch.ops import allpairs
from opticalflowcontainer_tpu_torch.ops import correlation as k4
from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3
from test_torch_correlation import CONFIGS
from test_torch_threads import one_torch_thread  # noqa: F401


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k4_plain_backward_matches_jax_vjp(name, rng):
    """The plain version's gradients for a random output gradient ==
    ``jax.vjp`` of ``correlation_lax``, odd sizes so the strided ragged
    edge is covered.  Tolerance 1e-5 of each gradient's scale: each input
    element gathers up to K*K products of the cotangent and the other
    input, summed in another order on the two sides."""
    max_disp, ds, os_ = CONFIGS[name]
    f1 = rng.standard_normal((2, 13, 17, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 13, 17, 8)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: correlation_lax(a, b, max_disp, ds, os_), f1, f2)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    t1, t2 = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
    got = torch.autograd.grad(k4.correlation_plain(t1, t2, max_disp, ds, os_),
                              (t1, t2), _nchw(cot))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, rtol=0, atol=1e-5 * np.abs(w).max())


CONVENTIONS = {
    "pixel_zeros": (lambda i, f: jwarp.warp_bilinear(i, f, "zeros"),
                    lambda i, f: twarp.warp_bilinear(i, f, "zeros")),
    "pixel_edge": (lambda i, f: jwarp.warp_bilinear(i, f, "edge"),
                   lambda i, f: twarp.warp_bilinear(i, f, "edge")),
    "align_corners": (jwarp.warp_align_corners, twarp.warp_align_corners),
    "half_pixel": (jwarp.warp_half_pixel, twarp.warp_half_pixel),
    "with_mask": (jwarp.warp_with_mask, twarp.warp_with_mask),
}


def _away_from_threshold(flow, H, W):
    """Whether no pixel's in-image tap weight lies within 1e-3 of the mask
    threshold 0.999 (the weight of the taps inside the image, in fp64)."""
    x = np.arange(W)[None, None] + flow[..., 0].astype(np.float64)
    y = np.arange(H)[None, :, None] + flow[..., 1].astype(np.float64)
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    total = 0.0
    for dy, dx, wt in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                       (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        inside = ((x0 + dx >= 0) & (x0 + dx <= W - 1)
                  & (y0 + dy >= 0) & (y0 + dy <= H - 1))
        total = total + np.where(inside, wt, 0.0)
    return bool((np.abs(total - 0.999) > 1e-3).all())


@pytest.mark.parametrize("name", sorted(CONVENTIONS))
def test_k3_plain_backward_matches_jax_vjp(name, rng):
    """Every warp convention's gradients (image and flow) for a random
    output gradient == ``jax.vjp`` of the reference's warp, flows reaching
    6 px out of the image.  PWC-Net's mask is a hard threshold: it passes
    no gradient on either side, and the flows keep every pixel's in-image
    weight 1e-3 away from it, so both sides gate the same pixels.
    Tolerance 1e-5 of each gradient's scale: the same fp32 operations, the
    flow's gradient a sum of four taps in another order."""
    B, C, H, W = 2, 3, 23, 31
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    flow = rng.uniform(-6, 6, (B, H, W, 2)).astype(np.float32)
    assert _away_from_threshold(flow, H, W)
    jfn, tfn = CONVENTIONS[name]
    out, vjp = jax.vjp(jfn, jnp.asarray(img), jnp.asarray(flow))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    ti, tf = _nchw(img).requires_grad_(), _nchw(flow).requires_grad_()
    got = torch.autograd.grad(tfn(ti, tf), (ti, tf), _nchw(cot))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k4_plain_gradcheck(name, rng):
    """``torch.autograd.gradcheck`` of the plain version in float64 (finite
    differences against autograd, gradcheck's own tolerances): the cost
    volume is bilinear in f1 and f2.  Its fast mode (the Jacobian against
    finite differences along random directions): the full Jacobian has a
    row for each of the K*K channels' outputs, thousands of backward
    passes."""
    max_disp, ds, os_ = CONFIGS[name]
    f1, f2 = (torch.from_numpy(rng.standard_normal((1, 3, 9, 11))).requires_grad_()
              for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b: k4.correlation_plain(a, b, max_disp, ds, os_), (f1, f2),
        fast_mode=True)


@pytest.mark.parametrize("padding,mask", [("zeros", None), ("edge", None),
                                          ("zeros", 0.999)])
def test_k3_plain_gradcheck(padding, mask, rng):
    """``gradcheck`` of the plain warp in float64 with respect to the image
    and both flow components.  The flows are drawn away from the kinks of
    bilinear sampling (integer coordinates, the mask threshold) that a
    1e-6 step could cross."""
    B, C, H, W = 1, 2, 7, 9
    src = torch.from_numpy(rng.standard_normal((B, C, H, W)))
    u = rng.uniform(-3, 3, (B, H, W))
    v = rng.uniform(-3, 3, (B, H, W))
    for a in (u, v):
        frac = a - np.floor(a)
        a[(frac < 1e-3) | (frac > 1 - 1e-3)] += 0.5
    assert _away_from_threshold(np.stack([u, v], -1), H, W)
    args = (src.requires_grad_(), torch.from_numpy(u).requires_grad_(),
            torch.from_numpy(v).requires_grad_())
    assert torch.autograd.gradcheck(
        lambda s, a, b: k3.warp_bilinear_plain(s, a, b, padding, mask), args)


def _counting(monkeypatch, module, plain):
    """The module's kernel forward stood in for by ``plain``, counting its
    calls: the Function then runs on CPU tensors."""
    calls = []

    def kernel(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(module, "_kernel", kernel)
    return calls


def test_correlation_function_backward_is_the_plain_autograd(monkeypatch, rng):
    """``CorrelationFunction``: one forward launch, and gradients equal to
    the plain version's autograd bit for bit (the same arithmetic), for a
    self-correlation (one tensor as both inputs, as LFN3's) and for
    a pair where only f2 needs a gradient."""
    calls = _counting(monkeypatch, k4, k4.correlation_plain)
    f = torch.from_numpy(rng.standard_normal((2, 5, 10, 12)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 5, 10, 12)).astype(np.float32))
    a = f.clone().requires_grad_()
    out = k4.CorrelationFunction.apply(a, a, 6, 2, 1)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (got,) = torch.autograd.grad(out, a, cot)
    b = f.clone().requires_grad_()
    (want,) = torch.autograd.grad(k4.correlation_plain(b, b, 6, 2, 1), b, cot)
    assert len(calls) == 1 and torch.equal(got, want)
    c = g.clone().requires_grad_()
    out = k4.CorrelationFunction.apply(f, c, 4, 1, 1)
    (got,) = torch.autograd.grad(out.square().sum(), c)
    d = g.clone().requires_grad_()
    (want,) = torch.autograd.grad(k4.correlation_plain(f, d, 4).square().sum(), d)
    assert len(calls) == 2 and torch.equal(got, want)


@pytest.mark.parametrize("mask", [None, 0.999])
def test_warp_function_backward_is_the_plain_autograd(mask, monkeypatch, rng):
    """``WarpFunction``: one forward launch, and the gradients of the image
    and of u, v equal the plain version's autograd bit for bit; with only
    u needing a gradient the others get none."""
    calls = _counting(monkeypatch, k3, k3.warp_bilinear_plain)
    src = torch.from_numpy(rng.standard_normal((2, 3, 11, 13)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-4, 4, (2, 11, 13)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-4, 4, (2, 11, 13)).astype(np.float32))
    cot = torch.randn(src.shape, generator=torch.Generator().manual_seed(1))
    ins = [t.clone().requires_grad_() for t in (src, u, v)]
    got = torch.autograd.grad(k3.WarpFunction.apply(*ins, "zeros", mask), ins, cot)
    ref = [t.clone().requires_grad_() for t in (src, u, v)]
    want = torch.autograd.grad(k3.warp_bilinear_plain(*ref, "zeros", mask), ref, cot)
    assert len(calls) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    uu = u.clone().requires_grad_()
    out = k3.WarpFunction.apply(src, uu, v, "edge", mask)
    (got,) = torch.autograd.grad(out, uu, cot)
    ur = u.clone().requires_grad_()
    (want,) = torch.autograd.grad(k3.warp_bilinear_plain(src, ur, v, "edge", mask), ur, cot)
    assert torch.equal(got, want)


def test_lookup_function_backward_is_the_plain_autograd(monkeypatch, rng):
    """``LookupFunction`` (K6's gradient, RAFT-small trains through the
    volume): one forward launch, and the volume's and the flow's gradients
    equal the plain lookup's autograd bit for bit; with only the volume
    needing one the flow gets none."""
    calls = _counting(monkeypatch, allpairs, allpairs._lookup_flat)
    vol = torch.from_numpy(rng.standard_normal((2, 7, 9, 7, 9)).astype(np.float32))
    packed = allpairs.pack_pyramid(allpairs.corr_pyramid(vol, 4))
    flow = torch.from_numpy(rng.uniform(-3, 3, (2, 2, 7, 9)).astype(np.float32))
    cot = torch.randn((2, 4 * 49, 7, 9), generator=torch.Generator().manual_seed(2))
    ins = [packed.flat.clone().requires_grad_(), flow.clone().requires_grad_()]
    got = torch.autograd.grad(
        allpairs.LookupFunction.apply(*ins, packed.sizes, 3), ins, cot)
    ref = [packed.flat.clone().requires_grad_(), flow.clone().requires_grad_()]
    want = torch.autograd.grad(allpairs._lookup_flat(*ref, packed.sizes, 3), ref, cot)
    assert len(calls) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    flat = packed.flat.clone().requires_grad_()
    out = allpairs.LookupFunction.apply(flat, flow, packed.sizes, 3)
    (got,) = torch.autograd.grad(out, flat, cot)
    assert torch.equal(got, want[0]) and len(calls) == 2


def test_wrappers_pass_a_gradient_on_the_cpu(rng):
    """On CPU tensors that need a gradient both wrappers run their plain
    versions (no launch counted) and the gradient reaches every input."""
    f = torch.from_numpy(rng.standard_normal((1, 4, 8, 8)).astype(np.float32))
    f.requires_grad_()
    uv = torch.zeros(1, 8, 8, requires_grad=True)
    before = (k3.warp_bilinear.launches, k4.local_correlation.launches)
    out = k4.local_correlation(f, k3.warp_bilinear(f, uv, uv), 4)
    grads = torch.autograd.grad(out.square().sum(), (f, uv))
    assert (k3.warp_bilinear.launches, k4.local_correlation.launches) == before
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
