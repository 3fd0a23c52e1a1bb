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


# ---------------------------------------------------------------- launch rule

# PWC-Net's five correlations at 640x480 (640x512 inside), levels 6..2, B=1
PWC_LEVELS_B1 = ((1, 196, 8, 10), (1, 128, 16, 20), (1, 96, 32, 40),
                 (1, 64, 64, 80), (1, 32, 128, 160))


def _blocks(cfg, B, H, W, max_disp, ds, os_):
    """Blocks of one launch of ``cfg`` and the most the shape allows (one
    per tile, tap row and split of MIN_SPLIT_CHANNELS channels)."""
    K = 2 * (max_disp // ds) + 1
    Ho, Wo = -(-H // os_), -(-W // os_)
    tw, th = cfg["tile"]
    tiles = B * -(-Wo // tw) * -(-Ho // th)
    return tiles * -(-K // cfg["taps"]) * cfg["splits"], tiles * K


def _shapes():
    """(name, max_disp, ds, os, B, C, H, W): the B=1 PWC-Net levels,
    LiteFlowNet's and LFN3's B=1 correlations, and chip_smoke's B=1 and B=8
    shapes of every configuration at 640x480."""
    import chip_smoke
    out = [(f"pwc_level{6 - i}", 4, 1, 1, *s) for i, s in enumerate(PWC_LEVELS_B1)]
    # LiteFlowNet's five and LFN3's six B=1 correlations
    out += [(what.replace(" ", "_"), *cfg, *shape)
            for what, cfg, shape in chip_smoke.CORR_B1
            if not what.startswith("PWC-Net")]
    for name, (md, ds, os_, C, H, W) in chip_smoke.CORR_AT_640x480.items():
        out += [(name, md, ds, os_, B, C, H, W) for B in (1, 8)]
    return out


@pytest.mark.parametrize("case", _shapes(), ids=lambda c: f"{c[0]}-B{c[4]}")
def test_k4_launch_config_fills_the_card(case):
    """Every SM gets a block, or as many blocks as the tiles, tap rows and
    channel splits of the shape allow; the block stays within the kernel's
    256 threads and 48 KB of shared memory."""
    _, md, ds, os_, B, C, H, W = case
    cfg = k4.launch_config(B, C, H, W, md, ds, os_)
    blocks, tap_rows = _blocks(cfg, B, H, W, md, ds, os_)
    most = tap_rows * max(1, C // k4.MIN_SPLIT_CHANNELS)
    assert blocks >= min(k4.H100_SMS, most), (cfg, blocks)
    assert cfg["threads"] <= k4.MAX_THREADS
    assert cfg["smem"] <= k4.SMEM_LIMIT
    assert 1 <= cfg["splits"] <= C and cfg["chunk"] >= 1
    assert cfg["tile"][0] % k4.STRIP == 0


def test_k4_launch_config_at_pwc_level6():
    """Level 6 (8 x 10 outputs, 196 channels) is one pixel tile: the grid
    takes its blocks from tap rows and channel splits."""
    cfg = k4.launch_config(1, 196, 8, 10, 4, 1, 1)
    blocks, _ = _blocks(cfg, 1, 8, 10, 4, 1, 1)
    assert cfg["tile"] == (12, 4) and cfg["splits"] > 1
    assert blocks >= k4.H100_SMS


@pytest.mark.parametrize("C", [1, 4, 37, 196, 197])
def test_k4_channel_splits_cover_C(C):
    """The splits' channel ranges tile [0, C) in order, none empty, ragged C
    included; the rule's split counts keep MIN_SPLIT_CHANNELS per split."""
    for splits in sorted(s for s in {1, 2, 3, 7, 16, 49, C // 2, C} if 1 <= s <= C):
        r = k4.channel_ranges(C, splits)
        assert r[0][0] == 0 and r[-1][1] == C
        assert all(a < b for a, b in r)
        assert all(r[i][1] == r[i + 1][0] for i in range(len(r) - 1))
    for B, H, W in ((1, 8, 10), (1, 45, 29), (8, 128, 160)):
        cfg = k4.launch_config(B, C, H, W, 4, 1, 1)
        assert cfg["splits"] == 1 or C // cfg["splits"] >= k4.MIN_SPLIT_CHANNELS


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k4_shared_memory_fits_in_every_configuration(name):
    """At every shape the rule is asked (the zoo's level sizes, ragged sizes
    and channel counts), the launch fits 48 KB of shared memory and 256
    threads, and its window stride holds the staged columns and the last
    strip's 16-byte reads."""
    md, ds, os_ = CONFIGS[name]
    K = 2 * (md // ds) + 1
    for B, C, H, W in ((1, 37, 29, 45), (2, 197, 10, 10), (8, 64, 240, 320),
                       (1, 196, 8, 10), (8, 32, 128, 160), (1, 3, 1, 1)):
        cfg = k4.launch_config(B, C, H, W, md, ds, os_)
        assert cfg["smem"] <= k4.SMEM_LIMIT and cfg["threads"] <= k4.MAX_THREADS
        wc, ws = k4._window(cfg["tile"][0], K, ds // os_)
        assert cfg["ws"] == ws >= wc and ws % 4 == 0 and wc % 4 == 0
        assert cfg == k4.make_config(md, ds, os_, cfg["tile"], cfg["taps"],
                                     cfg["splits"], cfg["chunk"], cfg["stages"])


def test_k4_launch_config_is_cached_and_checks_strides():
    """The wrapper computes a shape's configuration once; a disp_stride that
    is not a multiple of out_stride has no kernel."""
    assert k4.launch_config(8, 32, 128, 160, 4) is k4.launch_config(8, 32, 128, 160, 4)
    with pytest.raises(ValueError, match="multiple of out_stride"):
        k4.make_config(4, 1, 2, (32, 4), 3, 1, 8)
