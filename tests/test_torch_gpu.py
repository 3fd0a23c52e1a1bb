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
from opticalflowcontainer_tpu_torch.ops import farneback_update as k1
from opticalflowcontainer_tpu_torch.ops import solve2x2 as k2

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
