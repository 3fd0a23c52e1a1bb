"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs.  Marked ``gpu``; each test skips when no CUDA
device exists (decided in the fixture, never at import).  This file imports
neither JAX nor the JAX package, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu_torch.classical import farneback as fb
from opticalflowcontainer_tpu_torch.models import pwcnet
from opticalflowcontainer_tpu_torch.ops import correlation as k4
from opticalflowcontainer_tpu_torch.ops import farneback_update as k1
from opticalflowcontainer_tpu_torch.ops import solve2x2 as k2
from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(2, 45, 70), (1, 90, 160), (3, 2, 2)])
def test_update_kernel_matches_plain(shape, cuda):
    """Tolerance 1e-5 of M's scale: fp32 on both sides, the kernel with FMA
    contraction and another order of the bilinear products."""
    B, H, W = shape
    rng = np.random.default_rng(0)
    R0, R1 = (torch.from_numpy(rng.standard_normal((B, 5, H, W), np.float32)).to(cuda)
              for _ in range(2))
    u, v = (torch.from_numpy(rng.uniform(-6, 6, (B, H, W)).astype(np.float32)).to(cuda)
            for _ in range(2))
    before = k1.farneback_update.launches
    got = k1.farneback_update(R0, R1, u, v)
    want = k1.farneback_update_plain(R0, R1, u, v)
    torch.cuda.synchronize()
    assert k1.farneback_update.launches == before + 1
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("winsize,gaussian", [(15, False), (15, True), (41, False),
                                              (101, False), (1, False)])
def test_blur_solve_kernel_matches_plain(winsize, gaussian, cuda):
    """Tolerance 1e-4 of |u|, |v|'s scale: fp32 sums of up to 101 taps in
    another order, then a division.  Winsize 101 runs above 48 KB of shared
    memory (opt-in)."""
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal((2, 61, 83), np.float32) for _ in range(3))
    M = torch.from_numpy(np.stack([a * a + 0.5, 0.3 * a * b, b * b + 0.5, c,
                                   a * c], axis=1)).to(cuda)
    before = k2.blur_solve.launches
    got = k2.blur_solve(M, winsize, gaussian)
    want = k2.blur_solve_plain(M, winsize, gaussian)
    torch.cuda.synchronize()
    assert k2.blur_solve.launches == before + 1
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_clip_on_card_matches_cpu(cuda):
    """The whole slice: the card (kernels) against the CPU (plain versions),
    with the port's parity bar against the reference (mean 1e-3 px, max
    1e-2 px), and (levels+1)*iterations launches of each kernel."""
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 255, (96, 140)).astype(np.float32)
    frames = np.stack([base[:, 2 * t:2 * t + 128] for t in range(3)])
    k1.farneback_update.launches = k2.blur_solve.launches = 0
    on_card = fb.farneback_clip(frames, device=cuda).cpu().numpy()
    n = (fb._num_levels(96, 128, 3, 0.5) + 1) * 3
    assert k1.farneback_update.launches == k2.blur_solve.launches == n
    on_cpu = fb.farneback_clip(frames, device="cpu").numpy()
    d = np.abs(on_card - on_cpu)
    assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    R = torch.zeros(1, 5, 8, 8, device=cuda)
    uv = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        k1.farneback_update(R, R, uv.cpu(), uv)
    with pytest.raises(TypeError, match="float32"):
        k2.blur_solve(R.half(), 15)


@pytest.mark.parametrize("padding", ["zeros", "edge"])
@pytest.mark.parametrize("mask", [False, True])
def test_warp_kernel_matches_plain(padding, mask, cuda):
    """K3 with flows up to 8 px (many taps out of the image) and a column
    whose in-image weight straddles the 0.999 mask threshold.  The kernel
    forms the weights and the mask sum with the plain version's fp32
    operations in its order, so the gates agree at every pixel; the values
    agree to 1e-6 of max|src| (FMA contraction of the tap sum)."""
    B, C, H, W = 2, 7, 37, 70
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32) + 3).to(cuda)
    u = rng.uniform(-8, 8, (B, H, W)).astype(np.float32)
    v = rng.uniform(-8, 8, (B, H, W)).astype(np.float32)
    u[:, :, -1] = 0.001 + rng.uniform(-1e-6, 1e-6, (B, H))
    v[:, :, -1] = 0.0
    u, v = torch.from_numpy(u).to(cuda), torch.from_numpy(v).to(cuda)
    thr = 0.999 if mask else None
    before = k3.warp_bilinear.launches
    got = k3.warp_bilinear(src, u, v, padding, thr)
    want = k3.warp_bilinear_plain(src, u, v, padding, thr)
    torch.cuda.synchronize()
    assert k3.warp_bilinear.launches == before + 1
    assert torch.equal(got == 0, want == 0)
    assert (got - want).abs().max() <= 1e-6 * src.abs().max()


# (max_disp, disp_stride, out_stride) of every user of the correlation
CORR_CONFIGS = {"pwc": (4, 1, 1), "lfn_levels4to6": (3, 1, 1),
                "lfn_levels2to3": (6, 2, 2), "lfn3_cross": (4, 1, 1),
                "lfn3_self_level4": (6, 2, 1), "lfn3_self_level3": (8, 2, 1)}


@pytest.mark.parametrize("name", sorted(CORR_CONFIGS))
def test_correlation_kernel_matches_plain(name, cuda):
    """K4 on ragged sizes (29 x 45, not tile multiples) and 37 channels (not
    a multiple of the staged chunk).  Tolerance 1e-6 of max|f1| max|f2|:
    a mean of 37 fp32 products summed in another order."""
    max_disp, ds, os_ = CORR_CONFIGS[name]
    rng = np.random.default_rng(4)
    f1, f2 = (torch.from_numpy(rng.standard_normal((2, 37, 29, 45), np.float32)).to(cuda)
              for _ in range(2))
    before = k4.local_correlation.launches
    got = k4.local_correlation(f1, f2, max_disp, ds, os_)
    want = k4.correlation_plain(f1, f2, max_disp, ds, os_)
    torch.cuda.synchronize()
    assert k4.local_correlation.launches == before + 1
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * f1.abs().max() * f2.abs().max()


def test_kernels_refuse_a_gradient(cuda):
    """K3 and K4 have no backward yet: on the card they raise rather than
    drop the gradient, and run under no_grad."""
    f = torch.randn(1, 4, 8, 8, device=cuda, requires_grad=True)
    uv = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        k4.local_correlation(f, f, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        k3.warp_bilinear(f, uv, uv)
    with torch.no_grad():
        assert k4.local_correlation(f, f, 4).shape == (1, 81, 8, 8)
        assert k3.warp_bilinear(f, uv, uv).shape == f.shape


def test_pwcnet_on_card_matches_cpu(cuda):
    """estimate at 64 x 96 with seeded He-normal weights: the card (K3, K4,
    cuDNN with TF32 off) against the CPU (plain versions), 4 K3 and 5 K4
    launches per call.  Bounds: mean 1e-3 px, max 5e-2 px (fp32 sums in
    another order; the max allows a masked-warp threshold flip)."""
    g = torch.Generator().manual_seed(0)
    model = pwcnet.PWCNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d | torch.nn.ConvTranspose2d):
                fan_in = m.weight[0].numel() if isinstance(m, torch.nn.Conv2d) \
                    else m.weight.shape[0] * 4
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / fan_in) ** 0.5)
                m.bias.zero_()
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    b = np.roll(a, 3, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        k3.warp_bilinear.launches = k4.local_correlation.launches = 0
        on_card = pwcnet.estimate(model.to(cuda), a, b).cpu().numpy()
        assert (k3.warp_bilinear.launches, k4.local_correlation.launches) == (4, 5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    on_cpu = pwcnet.estimate(model.cpu(), a, b).numpy()
    d = np.abs(on_card - on_cpu)
    assert d.mean() <= 1e-3 and d.max() <= 5e-2, (d.mean(), d.max())
