"""The port's warps (``core/warp.py``) and K3's plain version
(``ops/warp_bilinear.py``), held against the JAX package on the CPU.

On the CPU the K3 wrapper runs its plain version; the CUDA kernel is held
against the same plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Inputs are made with numpy from a seed and handed to both
frameworks; the JAX side is NHWC, the port NCHW.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opticalflowcontainer_tpu.core import warp as jwarp
from opticalflowcontainer_tpu.ops.blockwarp import block_warp_bilinear_reference
from opticalflowcontainer_tpu_torch.core import warp as twarp
from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _inputs(rng, B=2, C=3, H=23, W=31, reach=6.0):
    """Image [B, H, W, C] and flow [B, H, W, 2] up to ``reach`` px, so many
    taps land outside the image."""
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    flow = rng.uniform(-reach, reach, (B, H, W, 2)).astype(np.float32)
    return img, flow


CONVENTIONS = {
    "pixel_zeros": (lambda i, f: jwarp.warp_bilinear(i, f, "zeros"),
                    lambda i, f: twarp.warp_bilinear(i, f, "zeros")),
    "pixel_edge": (lambda i, f: jwarp.warp_bilinear(i, f, "edge"),
                   lambda i, f: twarp.warp_bilinear(i, f, "edge")),
    "align_corners": (jwarp.warp_align_corners, twarp.warp_align_corners),
    "half_pixel": (jwarp.warp_half_pixel, twarp.warp_half_pixel),
    "with_mask": (jwarp.warp_with_mask, twarp.warp_with_mask),
}


@pytest.mark.parametrize("name", sorted(CONVENTIONS))
def test_warp_conventions_match_jax(name, rng):
    """Every warp convention == the reference's on the same inputs.
    Tolerance 1e-6 of the image's scale: the same fp32 operations in the
    same order on both sides (measured equal to the last bit or two)."""
    img, flow = _inputs(rng)
    jfn, tfn = CONVENTIONS[name]
    want = np.asarray(jfn(jnp.asarray(img), jnp.asarray(flow)))
    before = k3.warp_bilinear.launches
    got = _nhwc(tfn(_nchw(img), _nchw(flow)))
    assert k3.warp_bilinear.launches == before  # CPU tensors: plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(img).max())


@pytest.mark.parametrize("padding", ["zeros", "edge"])
def test_samplers_match_jax(padding, rng):
    """Samplers at arbitrary coordinates (an output grid of another size
    than the image, coordinates reaching 5 px outside it) and
    ``flow_grid_sample`` == the reference's.  Tolerance as above."""
    img = rng.normal(size=(2, 17, 21, 4)).astype(np.float32)
    x = rng.uniform(-5, 26, (2, 9, 11)).astype(np.float32)
    y = rng.uniform(-5, 22, (2, 9, 11)).astype(np.float32)
    jfn = jwarp.sample_bilinear_zeros if padding == "zeros" else jwarp.sample_bilinear_edge
    tfn = twarp.sample_bilinear_zeros if padding == "zeros" else twarp.sample_bilinear_edge
    want = np.asarray(jfn(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    got = _nhwc(tfn(_nchw(img), torch.from_numpy(x), torch.from_numpy(y)))
    atol = 1e-6 * np.abs(img).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    grid = np.stack([x, y], -1)
    want_g = np.asarray(jwarp.flow_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                               padding))
    got_g = _nhwc(twarp.flow_grid_sample(_nchw(img), torch.from_numpy(grid), padding))
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=atol)


@pytest.mark.parametrize("padding", ["zeros", "edge"])
@pytest.mark.parametrize("flow", ["const", "big", "smooth"])
def test_k3_plain_matches_block_warp_reference(flow, padding, rng):
    """K3's plain version == ``block_warp_bilinear_reference`` where the
    block warp is exact: flow within its slack of the block mean and inside
    its pad (the flows of tests/test_ops_blockwarp.py).  The reference
    samples in padded coordinates (x + 192 + u), whose fp32 ulp (2^-15 at
    up to 512) moves its weights by up to ~3e-5; the tolerance is 4 such
    ulps times the image's scale."""
    B, C, H, W = 2, 5, 48, 256
    src = rng.normal(size=(B, C, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if flow == "const":
        u = np.full((B, H, W), 2.3, np.float32)
        v = np.full((B, H, W), -1.7, np.float32)
    elif flow == "big":
        u = np.full((B, H, W), 11.6, np.float32)
        v = np.full((B, H, W), 7.2, np.float32)
    else:
        u = np.repeat((2.0 + 1.5 * np.sin(2 * np.pi * yy / H))[None], B, 0)
        v = np.repeat((-1.0 + np.cos(2 * np.pi * xx / W))[None], B, 0)
        u, v = u.astype(np.float32), v.astype(np.float32)
    want = np.asarray(block_warp_bilinear_reference(
        jnp.asarray(src), jnp.asarray(u), jnp.asarray(v), pad_mode=padding))
    got = k3.warp_bilinear(torch.from_numpy(src), torch.from_numpy(u),
                           torch.from_numpy(v), padding).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * 2.0 ** -15 * np.abs(src).max())


def _straddling_flow(H, W, B, rng, eps):
    """Flow whose out-of-image tap weight sits within ``eps`` of 0.001 for
    the pixels of the right-most column: the x coordinate lands at
    W - 1 + 0.001 + e, e in [-eps, eps], so the in-image weight is
    ~0.999 - e.  Elsewhere the flow is 0 (all taps in, weight 1)."""
    u = np.zeros((B, H, W), np.float32)
    u[:, :, -1] = (0.001 + rng.uniform(-eps, eps, (B, H))).astype(np.float32)
    return u, np.zeros_like(u)


def test_mask_away_from_threshold_matches_jax(rng):
    """With flows whose in-image tap weight is far from 0.999 (integer and
    half-pixel shifts, in and out of the image) the masked warp equals the
    reference's exactly: each weight is 0, 0.25, 0.5 or 1."""
    B, C, H, W = 2, 3, 16, 20
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    flow = rng.integers(-8, 9, (B, H, W, 2)).astype(np.float32) * 0.5
    want = np.asarray(jwarp.warp_with_mask(jnp.asarray(img), jnp.asarray(flow)))
    got = _nhwc(twarp.warp_with_mask(_nchw(img), _nchw(flow)))
    np.testing.assert_array_equal(got, want)
    assert (want == 0).all(-1).any() and (want != 0).all(-1).any()


def test_mask_straddling_threshold_matches_jax(rng):
    """Flows that straddle the 0.999 threshold: the ones-channel weight
    sums land within 1e-6 of it on both sides.  Both frameworks sum the
    same fp32 weights in the same order, so the port's gate equals the
    reference's at every pixel whose weight sum is more than 4 fp32 ulps
    (2.4e-7) from the threshold; at the rest a flip is allowed, and the
    test counts both kinds so that a straddle that does not straddle
    fails."""
    B, C, H, W = 2, 3, 40, 12
    img = (rng.normal(size=(B, H, W, C)) + 3.0).astype(np.float32)  # no zeros
    u, v = _straddling_flow(H, W, B, rng, 1e-6)
    flow = np.stack([u, v], -1)
    want = np.asarray(jwarp.warp_with_mask(jnp.asarray(img), jnp.asarray(flow)))
    ones = np.asarray(jwarp.warp_bilinear(jnp.ones((B, H, W, 1), jnp.float32),
                                          jnp.asarray(flow)))[..., 0]
    got = _nhwc(twarp.warp_with_mask(_nchw(img), _nchw(flow)))
    gate_want = (want != 0).all(-1)
    gate_got = (got != 0).all(-1)
    near = np.abs(ones - np.float32(0.999)) <= 4 * 2.0 ** -24
    last = np.zeros((B, H, W), bool)
    last[:, :, -1] = True
    assert (gate_want[last]).any() and (~gate_want[last]).any(), "no straddle"
    np.testing.assert_array_equal(gate_got[~near], gate_want[~near])
    np.testing.assert_allclose(got[gate_got & gate_want], want[gate_got & gate_want],
                               rtol=0, atol=1e-6 * np.abs(img).max())


def test_warp_wrapper_checks_its_inputs():
    src = torch.zeros(1, 2, 5, 6)
    uv = torch.zeros(1, 5, 6)
    with pytest.raises(ValueError, match="padding"):
        k3.warp_bilinear(src, uv, uv, "reflect")
    with pytest.raises(ValueError, match="u must be"):
        k3.warp_bilinear(src, uv[:, :4], uv)
    with pytest.raises(TypeError, match="float32"):
        k3.warp_bilinear(src.double(), uv, uv)
