"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs.  Marked ``gpu``; each test skips when no CUDA
device exists (decided in the fixture, never at import).  This file imports
neither JAX nor the JAX package, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import threading

import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu_torch.classical import farneback as fb
from opticalflowcontainer_tpu_torch.core import device as dv
from opticalflowcontainer_tpu_torch.core import spans
from opticalflowcontainer_tpu_torch.models import pwcnet, raft
from opticalflowcontainer_tpu_torch.ops import allpairs as k6
from opticalflowcontainer_tpu_torch.ops import correlation as k4
from opticalflowcontainer_tpu_torch.ops import farneback_prep as k5
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


# (B, h, w, radius, flow): RAFT's cell (1080p at 1/8, B = 2, r = 4) and
# RAFT-small's r = 3 there; 64x64 and 56x72 inputs' features, whose
# coarsest levels are 1 x 1 and 0 x 1
LOOKUP_CASES = [(2, 135, 240, 4, "subpixel"), (2, 135, 240, 4, "tens"),
                (2, 135, 240, 4, "outside"), (2, 135, 240, 3, "tens"),
                (2, 8, 8, 4, "tens"), (2, 8, 8, 3, "outside"),
                (2, 7, 9, 4, "subpixel"), (2, 7, 9, 3, "tens")]


@pytest.mark.parametrize("B,h,w,radius,kind", LOOKUP_CASES)
def test_lookup_kernel_matches_plain(B, h, w, radius, kind, cuda):
    """K6 against ``_lookup_packed`` on the same inputs, bit for bit: the
    kernel forms coordinates, floors, weights and the four-tap sum in the
    plain version's order without FMA contraction.  Taps off a level read
    exactly zero; a window off every level gives zeros.  One launch a
    call.  Inputs from chip_smoke.py's phase 7b (``k6_packed``,
    ``k6_flow``)."""
    import chip_smoke

    packed = chip_smoke.k6_packed(torch, B, h, w, cuda, seed=h * w + radius)
    flow = chip_smoke.k6_flow(torch, kind, B, h, w, cuda, seed=radius)
    before = k6.lookup_packed.launches
    got = k6.lookup_packed(packed, flow, radius)
    torch.cuda.synchronize()
    assert k6.lookup_packed.launches == before + 1
    want = k6._lookup_packed(packed, flow, radius)
    assert got.shape == (B, 4 * (2 * radius + 1) ** 2, h, w)
    assert torch.equal(got, want), float((got - want).abs().max())
    if kind == "outside":
        assert not got[..., ::2].any()


@pytest.mark.parametrize("radius", [3, 4])
def test_lookup_gradient_through_the_function(radius, cuda):
    """Under autograd the card runs ``LookupFunction``: its forward is K6
    (bit for bit the plain forward), its backward the plain version's
    autograd.  Gradients of the volume and the flow against the plain
    lookup's autograd on the card within 1e-5 of their max: the gather's
    backward adds with atomics, in no fixed order."""
    import chip_smoke

    packed = chip_smoke.k6_packed(torch, 2, 12, 17, cuda, seed=radius)
    flow = chip_smoke.k6_flow(torch, "tens", 2, 12, 17, cuda, seed=5) / 8
    cot = torch.randn((2, 4 * (2 * radius + 1) ** 2, 12, 17),
                      generator=torch.Generator(cuda).manual_seed(6), device=cuda)
    ins = [packed.flat.clone().requires_grad_(), flow.clone().requires_grad_()]
    before = k6.lookup_packed.launches
    out = k6.lookup_packed(packed._replace(flat=ins[0]), ins[1], radius)
    assert out.grad_fn is not None and k6.lookup_packed.launches == before + 1
    got = torch.autograd.grad(out, ins, cot)
    ref = [packed.flat.clone().requires_grad_(), flow.clone().requires_grad_()]
    plain = k6._lookup_packed(packed._replace(flat=ref[0]), ref[1], radius)
    want = torch.autograd.grad(plain, ref, cot)
    assert torch.equal(out.detach(), plain.detach())
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("cls", [raft.RAFTSmall, raft.RAFT], ids=["small", "large"])
def test_raft_launches_the_lookup_kernel_once_a_lookup(cls, cuda):
    """A RAFT estimate on the card counts as many K6 launches as lookups
    (``lookup_packed.calls``), and its flow matches the CPU's."""
    torch.manual_seed(8)
    model = cls().eval()
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (2, 1, 64, 96, 3)).astype(np.float32)
    on_cpu = raft.estimate(model, img[0], img[1], iters=3)
    model = model.to(cuda)
    calls, launches = k6.lookup_packed.calls, k6.lookup_packed.launches
    on_card = raft.estimate(model, img[0], img[1], iters=3).cpu()
    assert k6.lookup_packed.calls - calls == 3
    assert k6.lookup_packed.launches - launches == 3
    d = (on_card - on_cpu).abs()
    rms = float(on_cpu.square().mean().sqrt())
    assert float(d.mean()) <= 1e-3 * rms and float(d.max()) <= 5e-2 * rms


def test_clip_on_card_matches_cpu(cuda):
    """The whole slice: the card (kernels) against the CPU (plain versions),
    with the port's parity bar against the reference (mean 1e-3 px, max
    1e-2 px), and (levels+1)*iterations launches of each kernel."""
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 255, (96, 140)).astype(np.float32)
    frames = np.stack([base[:, 2 * t:2 * t + 128] for t in range(3)])
    k1.farneback_update.launches = k2.blur_solve.launches = 0
    k5.farneback_prep.launches = 0
    on_card = fb.farneback_clip(frames, device=cuda).cpu().numpy()
    levels = fb._num_levels(96, 128, 3, 0.5) + 1
    assert k1.farneback_update.launches == k2.blur_solve.launches == levels * 3
    assert k5.farneback_prep.launches == levels  # one prep launch a level
    on_cpu = fb.farneback_clip(frames, device="cpu").numpy()
    d = np.abs(on_card - on_cpu)
    assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())


def _level_args(H, W, k, pyr=0.5):
    """Level k's size and Gaussian taps, as ``_level_planes`` makes them."""
    return fb._level_size(H, W, pyr**k), fb._level_taps(k, pyr)


def _prep_gap(got, want, frames, floored=()):
    """Largest |got - want| of each plane over its scale: the plane's max
    abs, or for the planes ``floored`` a hundredth of the frames' max abs
    where that is larger (see ``test_prep_kernel_matches_plain``)."""
    scale = want.abs().amax(dim=(0, 2, 3))
    for c in floored:
        scale[c] = max(float(scale[c]), 1e-2 * float(frames.abs().max()))
    return float(((got - want).abs().amax(dim=(0, 2, 3)) / scale).max())


def _floored(H, W, k):
    """The planes whose scale has a floor: every plane of frames that blur
    to constants, axx and ayy (2, 3) at levels 2 and coarser."""
    return range(5) if (H, W) == (2, 2) else (2, 3) if k >= 2 else ()


@pytest.mark.parametrize("shape", [(2, 45, 70), (1, 481, 641), (6, 720, 1280), (3, 2, 2)])
@pytest.mark.parametrize("poly_n,sigma", [(5, 1.1), (7, 1.5)])
def test_prep_kernel_matches_plain(shape, poly_n, sigma, cuda):
    """K5 at every pyramid level against the plain ``_level_planes``
    operations on the same frames (on the card they equal the CPU's bit
    for bit), at the wrapper's tile and the other one.  Tolerance 1e-5 of
    each plane's max abs: fp32 on both sides, the kernel with FMA
    contraction and another order of the sums.  For axx and ayy at levels 2
    and 3 the scale is at least a hundredth of the frames' max abs: there
    the level's mean (~127) cancels in ig03 s0 + ig33 sxx, and the plain
    version alone is up to 1.3e-5 of those planes' max from float64 (720p,
    poly_n 7, measured on the CPU; bx, by and qxy at most 2.8e-6).  (3, 2,
    2) frames blur to constants (reflect101 of two pixels), so all their
    planes are rounding noise around 0 and take the same floor.  One launch
    a call."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(cuda)
    N, H, W = shape
    for k in range(fb._num_levels(H, W, 3, 0.5) + 1):
        size, blur = _level_args(H, W, k)
        want = k5.farneback_prep_plain(img, size, blur, poly_n, sigma)
        before = k5.farneback_prep.launches
        got = fb._level_planes(img, H, W, k, 0.5, poly_n, sigma)
        torch.cuda.synchronize()
        assert k5.farneback_prep.launches == before + 1
        assert _prep_gap(got, want, img, _floored(H, W, k)) <= 1e-5, k
        for tile in k5.TILES:
            other = torch.empty_like(want)
            k5.launch(img, other, blur, poly_n, sigma, tile)
            torch.cuda.synchronize()
            assert _prep_gap(other, want, img, _floored(H, W, k)) <= 1e-5, (k, tile)


def test_prep_kernel_64bit_offsets(cuda):
    """frames * 5 * H * W >= 2^31 takes the 64-bit offsets: the last frames'
    planes lie past 2^31 and must equal the plain version's of those
    frames.  Needs ~12 GB free on the card, else skips."""
    N, H, W = 210, 1080, 1920
    assert N * 5 * H * W >= 2**31
    free, _ = torch.cuda.mem_get_info(cuda)
    if free < 12 * 2**30:
        pytest.skip(f"needs ~12 GB of free device memory, {free / 2**30:.1f} GB free")
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand((N, H, W), generator=g, device=cuda) * 255
    size, blur = _level_args(H, W, 0)
    got = k5.farneback_prep(img, size, blur, 5, 1.1)
    for f in (slice(0, 1), slice(N - 2, N)):
        want = k5.farneback_prep_plain(img[f].contiguous(), size, blur, 5, 1.1)
        assert _prep_gap(got[f], want, img[f]) <= 1e-5
    del img, got


@pytest.mark.parametrize("poly_n,sigma", [(1, 0.6), (3, 0.9), (9, 2.0), (15, 3.2)])
def test_prep_kernel_runs_any_poly_n(poly_n, sigma, cuda):
    """poly_n other than 5 and 7 run the kernel's variant that reads it at
    run time, held to the plain version as ``test_prep_kernel_matches_plain``
    holds the unrolled ones, at every level and both tiles; past
    ``MAX_POLY_N`` the wrapper raises on the card."""
    rng = np.random.default_rng(4)
    N, H, W = 2, 481, 641
    img = torch.from_numpy(rng.uniform(0, 255, (N, H, W)).astype(np.float32)).to(cuda)
    for k in range(fb._num_levels(H, W, 3, 0.5) + 1):
        size, blur = _level_args(H, W, k)
        want = k5.farneback_prep_plain(img, size, blur, poly_n, sigma)
        before = k5.farneback_prep.launches
        got = fb._level_planes(img, H, W, k, 0.5, poly_n, sigma)
        torch.cuda.synchronize()
        assert k5.farneback_prep.launches == before + 1
        assert _prep_gap(got, want, img, _floored(H, W, k)) <= 1e-5, k
        for tile in k5.TILES:
            other = torch.empty_like(want)
            k5.launch(img, other, blur, poly_n, sigma, tile)
            torch.cuda.synchronize()
            assert _prep_gap(other, want, img, _floored(H, W, k)) <= 1e-5, (k, tile)
    size, blur = _level_args(H, W, 1)
    for bad in (0, k5.MAX_POLY_N + 1):
        with pytest.raises(ValueError, match="poly_n"):
            k5.farneback_prep(img, size, blur, bad, 1.0)


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
    forms the weights, the mask sum and the tap sum with the plain version's
    fp32 operations in its order, so the gates agree at every pixel; the
    values agree to 1e-6 of max|src| (equal in practice)."""
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


def _k3_case(rng, B, C, H, W, reach, device):
    src = torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32) + 3)
    u = rng.uniform(-reach, reach, (B, H, W)).astype(np.float32)
    v = rng.uniform(-reach, reach, (B, H, W)).astype(np.float32)
    return src.to(device), torch.from_numpy(u).to(device), torch.from_numpy(v).to(device)


@pytest.mark.parametrize("shape", [(1, 7, 37, 70), (2, 33, 37, 70),
                                   (2, 33, 200, 200), (3, 7, 1, 1),
                                   (1, 33, 3, 5), (1, 128, 16, 20)])
@pytest.mark.parametrize("padding", ["zeros", "edge"])
@pytest.mark.parametrize("mask", [False, True])
def test_warp_kernel_ragged_channels_and_tiny_images(shape, padding, mask, cuda):
    """K3 at channel counts that are not multiples of the group size the
    launch picks (C=33 runs 9 groups of 4, the last of 1; C=7 runs 7 groups
    of 1), on 1x1 and 3x5 images and at
    PWC-Net's level 5 (128 groups of 1).  Same bar as above: equal gates,
    values to 1e-6 of max|src|."""
    rng = np.random.default_rng(6)
    src, u, v = _k3_case(rng, *shape, reach=4.0, device=cuda)
    thr = 0.999 if mask else None
    got = k3.warp_bilinear(src, u, v, padding, thr)
    want = k3.warp_bilinear_plain(src, u, v, padding, thr)
    torch.cuda.synchronize()
    assert torch.equal(got == 0, want == 0)
    assert (got - want).abs().max() <= 1e-6 * src.abs().max()


@pytest.mark.parametrize("padding", ["zeros", "edge"])
def test_warp_kernel_nan_and_huge_displacements(padding, cuda):
    """A NaN or +-1e30 displacement makes no tap and no out-of-range
    offset: zeros padding gives 0 there, edge padding clamps (NaN to 0, as
    the plain version's nan_to_num does); the rest of the image is
    untouched.  Run at C=33: 9 channel groups, the last of one channel."""
    rng = np.random.default_rng(7)
    src, u, v = _k3_case(rng, 2, 33, 9, 13, reach=3.0, device=cuda)
    specials = torch.tensor([float("nan"), 1e30, -1e30, float("inf")], device=cuda)
    u[0, 0, :4] = specials
    v[0, 1, :4] = specials
    u[1, 2, 5] = float("nan")
    v[1, 2, 5] = 1e30
    for thr in (None, 0.999):
        got = k3.warp_bilinear(src, u, v, padding, thr)
        want = k3.warp_bilinear_plain(src, u, v, padding, thr)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got == 0, want == 0)
        assert (got - want).abs().max() <= 1e-6 * src.abs().max()
        if padding == "zeros":
            assert bool((got[0, :, 0, :4] == 0).all()) and bool((got[1, :, 2, 5] == 0).all())


def test_warp_kernel_variants_agree_bit_for_bit(cuda):
    """Every launch configuration the kernel takes (32- or 64-bit offsets,
    any channel-group count, both borders, mask off and on) computes the
    same fp32 operations in the same order: outputs equal bit for bit."""
    rng = np.random.default_rng(8)
    src, u, v = _k3_case(rng, 2, 33, 37, 70, reach=6.0, device=cuda)
    base = k3.launch_config(*src.shape)
    for padding in ("zeros", "edge"):
        for thr in (None, 0.999):
            want = k3.launch(src, u, v, padding, thr, **base)
            for wide in (False, True):
                for groups in (1, 5, 33):
                    got = k3.launch(src, u, v, padding, thr, groups=groups, wide=wide)
                    assert torch.equal(got, want), (padding, thr, wide, groups)


def test_warp_kernel_64bit_offsets(cuda):
    """B*C*H*W >= 2^31 takes the 64-bit offsets: the last channels' values
    lie past 2^31 and must equal the plain version's warp of those
    channels.  Needs ~18 GB free on the card, else skips."""
    B, C, H, W = 1, 33, 8192, 8000
    assert B * C * H * W >= 2**31
    free, _ = torch.cuda.mem_get_info(cuda)
    if free < 20 * 2**30:
        pytest.skip(f"needs ~18 GB of free device memory, {free / 2**30:.1f} GB free")
    assert k3.launch_config(B, C, H, W)["wide"]
    g = torch.Generator(device=cuda).manual_seed(0)
    src = torch.randn((B, C, H, W), generator=g, device=cuda) + 3
    u = torch.rand((B, H, W), generator=g, device=cuda) * 12 - 6
    v = torch.rand((B, H, W), generator=g, device=cuda) * 12 - 6
    got = k3.warp_bilinear(src, u, v, "zeros", 0.999)
    for c in (slice(0, 1), slice(C - 2, C)):
        want = k3.warp_bilinear_plain(src[:, c].contiguous(), u, v, "zeros", 0.999)
        assert torch.equal(got[:, c] == 0, want == 0)
        assert (got[:, c] - want).abs().max() <= 1e-6 * src.abs().max()
    del src, got


@pytest.mark.parametrize("winsize,gaussian", [(13, False), (13, True), (15, False),
                                              (15, True), (9, False), (21, True)])
@pytest.mark.parametrize("shape", [(2, 37, 71), (1, 480, 640), (1, 60, 80)])
def test_blur_solve_kernels_at_ragged_sizes(winsize, gaussian, shape, cuda):
    """K2 on sizes that are not tile multiples.  Radii 6 and 7 run the
    register-blocked kernel, others the generic one (``variant``).  For
    r = 6, 7 every register tile and the generic kernel are held against the
    plain version too, so both kernels are checked at these radii.
    Tolerance 1e-4 of scale, as above."""
    rng = np.random.default_rng(9)
    B, H, W = shape
    a, b, c = (rng.standard_normal((B, H, W), np.float32) for _ in range(3))
    M = torch.from_numpy(np.stack([a * a + 0.5, 0.3 * a * b, b * b + 0.5, c,
                                   a * c], axis=1)).to(cuda)
    r = winsize // 2
    assert k2.variant(r) == (f"r{r}" if r in (6, 7) else "generic")
    want = k2.blur_solve_plain(M, winsize, gaussian)
    runs = [k2.blur_solve(M, winsize, gaussian)]
    if r in k2.REG_RADII:
        runs += [k2.launch(M, winsize, gaussian, True, t) for t in k2.REG_TILES]
        runs.append(k2.launch(M, winsize, gaussian, False, (32, 64)))
    torch.cuda.synchronize()
    for got in runs:
        for g, w in zip(got, want):
            assert (g - w).abs().max() <= 1e-4 * w.abs().max()


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


# PWC-Net's five correlations at 640x480, B=1 (levels 6..2), and a ragged
# 197 channels at level 6's width
K4_B1_SHAPES = [(1, 196, 8, 10), (1, 128, 16, 20), (1, 96, 32, 40),
                (1, 64, 64, 80), (1, 32, 128, 160), (1, 197, 8, 10)]


@pytest.mark.parametrize("shape", K4_B1_SHAPES)
def test_correlation_kernel_at_pwc_b1_levels(shape, cuda):
    """K4 at the stream node's shapes, where the grid splits taps and
    channels (level 6 is one pixel tile): against the plain version at
    1e-6 of max|f1| max|f2| (a mean of C fp32 products in another order),
    one counted launch a call."""
    rng = np.random.default_rng(11)
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
              for _ in range(2))
    before = k4.local_correlation.launches
    got = k4.local_correlation(f1, f2, 4)
    want = k4.correlation_plain(f1, f2, 4)
    torch.cuda.synchronize()
    assert k4.local_correlation.launches == before + 1
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * f1.abs().max() * f2.abs().max()


@pytest.mark.parametrize("shape,config", [((1, 196, 8, 10), (4, 1, 1)),
                                          ((8, 32, 128, 160), (4, 1, 1)),
                                          ((2, 37, 29, 45), (6, 2, 2))])
def test_correlation_kernel_is_deterministic(shape, config, cuda):
    """A fixed summation order (channels, then splits, no atomics): two
    launches on the same inputs are equal bit for bit."""
    rng = np.random.default_rng(12)
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
              for _ in range(2))
    first = k4.local_correlation(f1, f2, *config)
    for _ in range(3):
        assert torch.equal(k4.local_correlation(f1, f2, *config), first)


@pytest.mark.parametrize("name", sorted(CORR_CONFIGS))
def test_correlation_variants_agree(name, cuda):
    """Every launch choice ``chip_smoke.py --variants`` times, and one or two
    buffers of 1 or 3 channels (a split of one chunk included), agree
    with the plain version at 1e-6 of max|f1| max|f2|; those with the chosen
    channel splits equal the chosen launch bit for bit."""
    import chip_smoke

    max_disp, ds, os_ = CORR_CONFIGS[name]
    rng = np.random.default_rng(13)
    for B, C, H, W in ((2, 37, 29, 45), (1, 196, 8, 10), (1, 24, 32, 40)):
        f1, f2 = (torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32))
                  .to(cuda) for _ in range(2))
        chosen = k4.launch_config(B, C, H, W, max_disp, ds, os_)
        want = k4.launch(f1, f2, max_disp, ds, os_, chosen)
        plain = k4.correlation_plain(f1, f2, max_disp, ds, os_)
        tol = 1e-6 * f1.abs().max() * f2.abs().max()
        variants = list(chip_smoke.k4_variant_configs(max_disp, ds, os_, C, W,
                                                      chosen).values())
        variants += [k4.make_config(max_disp, ds, os_, chosen["tile"], chosen["taps"],
                                    splits, chunk, stages)
                     for splits in (1, 4) for chunk in (1, 3) for stages in (1, 2)]
        for cfg in variants:
            got = k4.launch(f1, f2, max_disp, ds, os_, cfg)
            torch.cuda.synchronize()
            assert (got - plain).abs().max() <= tol, cfg
            if cfg["splits"] == chosen["splits"]:
                assert torch.equal(got, want), cfg


def test_kernels_take_a_gradient(cuda):
    """K3 and K4 with inputs that need a gradient: the forward is the
    kernel (counted), the backward the plain versions' autograd; the
    gradients equal the plain path's within 1e-5 of their scale (the same
    plain backward at forward values that differ by fp32 summation order).
    Under no_grad the kernels run as before."""
    g = torch.Generator(device=cuda).manual_seed(0)
    f1 = torch.randn(2, 8, 12, 16, device=cuda, generator=g, requires_grad=True)
    f2 = torch.randn(2, 8, 12, 16, device=cuda, generator=g, requires_grad=True)
    u = (3 * torch.randn(2, 12, 16, device=cuda, generator=g)).requires_grad_()
    v = (3 * torch.randn(2, 12, 16, device=cuda, generator=g)).requires_grad_()
    w = torch.randn(2, 81, 12, 16, device=cuda, generator=g)
    for mask in (None, 0.999):
        k3.warp_bilinear.launches = k4.local_correlation.launches = 0
        out = k4.local_correlation(f1, k3.warp_bilinear(f2, u, v, "zeros", mask), 4)
        got = torch.autograd.grad((out * w).sum(), (f1, f2, u, v))
        assert (k3.warp_bilinear.launches, k4.local_correlation.launches) == (1, 1)
        plain = k4.correlation_plain(
            f1, k3.warp_bilinear_plain(f2, u, v, "zeros", mask), 4)
        want = torch.autograd.grad((plain * w).sum(), (f1, f2, u, v))
        for a, b in zip(got, want):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), mask
    with torch.no_grad():
        assert k4.local_correlation(f1, f1, 4).shape == (2, 81, 12, 16)
        assert k3.warp_bilinear(f1, u, v).shape == f1.shape


def test_pwcnet_training_step_through_the_kernels(cuda):
    """One step of PWC-Net's training loss (train_flow's, B=2, 64x64, the
    trainer's init) through the kernels: 4 K3 and 5 K4 launches, a finite
    loss, and the gradients within chip_smoke.TRAIN_GRAD_REL of the plain
    path's on the model's scale (cuDNN in fp32 and deterministic on both;
    the bars' reasons are beside that constant)."""
    import chip_smoke
    from opticalflowcontainer_tpu_torch.tools import train_flow

    batch = chip_smoke.train_batch(torch, cuda, B=2, H=64, W=64, seed=3)
    model = chip_smoke.trainer_init(torch, "pwcnet", cuda, seed=3)
    loss_fn = train_flow.make_loss("pwcnet")
    with chip_smoke.exact_convolutions(torch):
        k3.warp_bilinear.launches = k4.local_correlation.launches = 0
        loss, grads = chip_smoke.train_grads(torch, model, loss_fn, batch)
        assert (k3.warp_bilinear.launches, k4.local_correlation.launches) == (4, 5)
        with chip_smoke.plain_kernels():
            plain, want = chip_smoke.train_grads(torch, model, loss_fn, batch)
    assert torch.isfinite(loss) and abs(float(loss) - float(plain)) <= 1e-5 * float(plain)
    worst, l2 = chip_smoke.grad_gap(torch, grads, want)
    assert worst <= chip_smoke.TRAIN_GRAD_REL and l2 <= chip_smoke.TRAIN_GRAD_REL


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


def _lfn_b1_correlations():
    import chip_smoke

    return [c for c in chip_smoke.CORR_B1 if c[0].startswith(("LiteFlowNet", "LFN3"))]


def _neuflow_correlations():
    import chip_smoke

    return [c for c in chip_smoke.CORR_B1 if c[0].startswith("NeuFlow")]


@pytest.mark.parametrize("case", _lfn_b1_correlations(), ids=lambda c: c[0])
def test_correlation_kernel_at_lfn_b1_correlations(case, cuda):
    """K4 at LiteFlowNet's five and LFN3's six B=1 correlations (a
    self-correlation passes one tensor as f1 and f2): against the plain
    version at 1e-6 of max|f1| max|f2|, and a second launch bit for bit."""
    what, config, shape = case
    rng = np.random.default_rng(14)
    f1 = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
    f2 = f1 if "self" in what else torch.from_numpy(
        rng.standard_normal(shape, np.float32)).to(cuda)
    got = k4.local_correlation(f1, f2, *config)
    want = k4.correlation_plain(f1, f2, *config)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * f1.abs().max() * f2.abs().max()
    assert torch.equal(k4.local_correlation(f1, f2, *config), got)


@pytest.mark.parametrize("shape", [(1, 2, 60, 80), (1, 2, 120, 160),
                                   (1, 3, 240, 320), (1, 64, 240, 320)])
def test_warp_kernel_at_lfn_shapes(shape, cuda):
    """K3 at LFN3's flow deformation (C=2), LiteFlowNet's level-2 image and
    feature warps (C=3, 64), B=1, zeros padding: bit-equal to the plain
    version (the tap sum rounded in its order)."""
    rng = np.random.default_rng(15)
    B, C, H, W = shape
    src = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
    u, v = (torch.from_numpy(rng.uniform(-9, 9, (B, H, W)).astype(np.float32)).to(cuda)
            for _ in range(2))
    got = k3.warp_bilinear(src, u, v)
    want = k3.warp_bilinear_plain(src, u, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", _neuflow_correlations(), ids=lambda c: c[0])
def test_correlation_kernel_at_neuflow_shapes(case, cuda):
    """K4 (radius 4, K=9) at NeuFlowLite's 1/8 correlation at 640x480 and
    NeuFlow-v2's 1/16 and 1/8 ones at 768x432: against the plain version at
    1e-6 of max|f1| max|f2|, and a second launch bit for bit."""
    _, config, shape = case
    rng = np.random.default_rng(17)
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
              for _ in range(2))
    got = k4.local_correlation(f1, f2, *config)
    want = k4.correlation_plain(f1, f2, *config)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (1, 81) + shape[2:]
    assert (got - want).abs().max() <= 1e-6 * f1.abs().max() * f2.abs().max()
    assert torch.equal(k4.local_correlation(f1, f2, *config), got)


@pytest.mark.parametrize("shape", [(1, 64, 60, 80), (1, 128, 27, 48), (1, 128, 54, 96)])
def test_warp_kernel_at_neuflow_shapes(shape, cuda):
    """K3 at NeuFlow's feature warps (NeuFlowLite 1/8 at 640x480, NeuFlow-v2
    1/16 and 1/8 at 768x432), zeros padding: bit-equal to the plain
    version."""
    rng = np.random.default_rng(18)
    B, C, H, W = shape
    src = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda)
    u, v = (torch.from_numpy(rng.uniform(-9, 9, (B, H, W)).astype(np.float32)).to(cuda)
            for _ in range(2))
    got = k3.warp_bilinear(src, u, v)
    want = k3.warp_bilinear_plain(src, u, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("v2", [False, True], ids=["lite", "v2"])
def test_neuflow_on_card_matches_cpu(v2, cuda):
    """estimate at 64 x 96 with chip_smoke's seeded weights: the card (K3,
    K4, fp32 convolutions) against the CPU (plain versions), with 2 and 2
    (NeuFlowLite) or 9 and 9 (NeuFlow-v2) K3 and K4 launches per call.
    Bounds relative to the flow's RMS, as chip_smoke's: mean 1e-3, max
    5e-2."""
    import chip_smoke
    from opticalflowcontainer_tpu_torch.models import neuflow, neuflow_v2

    mod, cls, tag = ((neuflow_v2, neuflow_v2.NeuFlowV2, "neuflow_v2") if v2
                     else (neuflow, neuflow.NeuFlowLite, "neuflow_lite"))
    model = chip_smoke.seeded_neuflow(torch, cls, 0, "cpu")
    rng = np.random.default_rng(19)
    a = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    b = np.roll(a, 3, 1)
    k3.warp_bilinear.launches = k4.local_correlation.launches = 0
    on_card = mod.estimate(model.to(cuda), a, b).cpu().numpy()
    assert {"warp_bilinear": k3.warp_bilinear.launches,
            "local_correlation": k4.local_correlation.launches} == \
        chip_smoke.NEUFLOW_LAUNCHES[tag]
    on_cpu = mod.estimate(model.cpu(), a, b).numpy()
    rms = np.sqrt((on_cpu ** 2).mean())
    d = np.abs(on_card - on_cpu)
    assert d.mean() <= 1e-3 * rms and d.max() <= 5e-2 * rms, (d.mean(), d.max(), rms)


def test_bf16_stream_launches_the_kernels_on_card(cuda):
    """FusedModelStream(bf16=True) over a seeded NeuFlowLite on the card:
    bf16 parameters, du fp32 and finite, and the fp32 stream's K3 and K4
    launches (the kernels, not their plain versions, serve bf16)."""
    import chip_smoke
    from opticalflowcontainer_tpu_torch.models import neuflow
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedModelStream

    model = chip_smoke.seeded_neuflow(torch, neuflow.NeuFlowLite, 0, cuda)
    frames = chip_smoke.bgr_frames(torch, 96, 128, 4, 1.5, seed=3, device=cuda)
    counts = []
    for bf16 in (False, True):
        s = FusedModelStream(model, neuflow.estimate, bf16=bf16, device=cuda)
        s.step(frames[0])
        k3.warp_bilinear.launches = k4.local_correlation.launches = 0
        dus = [s.step(f) for f in frames[1:]]
        assert all(du.dtype == torch.float32 and torch.isfinite(du) for du in dus)
        counts.append((k3.warp_bilinear.launches, k4.local_correlation.launches))
    assert all(p.dtype == torch.bfloat16 for p in s.model.parameters())
    assert counts[0] == counts[1] == (6, 6)


@pytest.mark.parametrize("three", [True, False], ids=["lfn3", "lfn"])
def test_liteflownet_on_card_matches_cpu(three, cuda):
    """estimate at 64 x 96 with chip_smoke's seeded weights: the card (K3,
    K4, cuDNN with TF32 off) against the CPU (plain versions), with 13 K3
    and 6 K4 launches per LFN3 call, 14 and 5 per LiteFlowNet call.  Bounds
    as for PWC-Net: mean 1e-3 px, max 5e-2 px."""
    import chip_smoke
    from opticalflowcontainer_tpu_torch.models import liteflownet, liteflownet3

    mod = liteflownet3 if three else liteflownet
    cls = mod.LiteFlowNet3 if three else mod.LiteFlowNet
    expect = chip_smoke.LFN3_LAUNCHES if three else chip_smoke.LFN_LAUNCHES
    model = chip_smoke.seeded_liteflownet(torch, cls, 0, "cpu")
    rng = np.random.default_rng(16)
    a = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    b = np.roll(a, 3, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        k3.warp_bilinear.launches = k4.local_correlation.launches = 0
        on_card = mod.estimate(model.to(cuda), a, b).cpu().numpy()
        assert {"warp_bilinear": k3.warp_bilinear.launches,
                "local_correlation": k4.local_correlation.launches} == expect
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    on_cpu = mod.estimate(model.cpu(), a, b).numpy()
    d = np.abs(on_card - on_cpu)
    assert d.mean() <= 1e-3 and d.max() <= 5e-2, (d.mean(), d.max())


def test_model_stream_step_many_equals_step_on_card(cuda):
    """FusedModelStream over a seeded LFN3 on the card: five frames from
    one upload equal five steps bit for bit."""
    import chip_smoke
    from opticalflowcontainer_tpu_torch.models import liteflownet3
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedModelStream

    model = chip_smoke.seeded_liteflownet(torch, liteflownet3.LiteFlowNet3, 0, cuda)
    rng = np.random.default_rng(17)
    base = rng.uniform(0, 255, (64, 120, 3)).astype(np.uint8)
    frames = np.stack([base[:, 2 * i:2 * i + 96] for i in range(6)])
    a = FusedModelStream(model, liteflownet3.estimate, device=cuda)
    b = FusedModelStream(model, liteflownet3.estimate, device=cuda)
    a.step(frames[0])
    b.step(frames[0])
    per_frame = torch.stack([a.step(f) for f in frames[1:]])
    assert torch.equal(b.step_many(frames[1:]), per_frame)
    assert per_frame.device.type == "cuda" and bool(torch.isfinite(per_frame).all())


def test_stateful_batcher_matches_per_stream_streams_on_card(cuda):
    """The 2-stream stateful batcher on the card against one
    FusedFarnebackStream per stream on the same frames, through a late
    join and a dropped-pair reseed: du within 1e-4 px (each row is reduced
    as a single stream reduces; K1 and K2 are per pixel)."""
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedFarnebackStream
    from opticalflowcontainer_tpu_torch.runtime.multistream import (
        make_stateful_batched_fused_farneback)

    rng = np.random.default_rng(21)
    base = rng.uniform(0, 255, (2, 120, 200)).astype(np.float32)
    # [5, 2, 120, 160]: stream s moves s + 1 px a frame
    f = np.stack([np.stack([base[s, :, (s + 1) * t:(s + 1) * t + 160]
                            for s in range(2)]) for t in range(5)])
    kw = dict(levels=3, winsize=15, iterations=3)
    st = make_stateful_batched_fused_farneback(2, device=cuda, **kw)
    refs = [FusedFarnebackStream(device=cuda, **kw) for _ in range(2)]
    k1.farneback_update.launches = k2.blur_solve.launches = 0
    worst = 0.0
    # (rows, frame t, dropped): stream 1 joins at t=2 and skips t=3
    for idxs, t, dropped in (([0], 1, None), ([0, 1], 2, None), ([0], 3, None),
                             ([0, 1], 4, [False, True])):
        got = st(f[t - 1][idxs], f[t][idxs], idxs, dropped)
        want = []
        for i in idxs:
            if refs[i]._state is None or (dropped and dropped[idxs.index(i)]):
                refs[i].reset()
                refs[i].step(f[t - 1][i])
            want.append(refs[i].step(f[t][i]))
        worst = max(worst, float((got - torch.stack(want)).abs().max()))
    assert worst <= 1e-4, worst
    assert k1.farneback_update.launches > 0 and k2.blur_solve.launches > 0


def test_flow_node_over_card_backend(cuda):
    """A FlowNode over the card's Farneback backend against the same node
    on the CPU, topic mode (1 m per px, dt 1 s: vx is the mean u): within
    1e-3 px, the card-vs-CPU bar of the clip; then stream mode, where the
    consumer thread launches the kernels: nothing fails, every thread
    ends."""
    from opticalflowcontainer_tpu_torch.runtime.bus import Bus
    from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg
    from opticalflowcontainer_tpu_torch.runtime.nodes import (
        FlowNode, NodeParams, make_farneback_backend)
    from opticalflowcontainer_tpu_torch.runtime.sources import SyntheticCamera

    cam = SyntheticCamera(width=160, height=120, n_frames=6, velocity_mps=0.05)
    vels = {}
    for dev in (cuda, "cpu"):
        bus = Bus(namespace="")
        node = FlowNode(make_farneback_backend(device=dev, levels=2, winsize=13,
                                               iterations=2),
                        NodeParams(pixel_to_meter=1.0, name="G"), bus).attach()
        out = vels.setdefault(str(dev), [])
        bus.subscribe("/optical_flow/G_velocity", lambda m, out=out: out.append(m.x))
        for i in range(6):
            bus.publish("/camera/color/image_raw",
                        ImageMsg(Header(float(i)), cam.frame_at(i)))
        node.stop()
    assert len(vels[str(cuda)]) == 5
    assert np.abs(np.subtract(vels[str(cuda)], vels["cpu"])).max() <= 1e-3
    node = FlowNode(make_farneback_backend(device=cuda, levels=2, winsize=13,
                                           iterations=2), NodeParams(name="T"))
    before = k1.farneback_update.launches
    try:
        node.start_stream(SyntheticCamera(width=160, height=120, n_frames=8,
                                          fps=30.0))
        assert node.wait(timeout=60.0)
    finally:
        node.stop()
    assert node.frames_failed == 0 and node.frames_processed > 0
    assert k1.farneback_update.launches > before
    assert not any(t.is_alive() for t in node._threads)


def test_resize_area_unchanged_by_device(cuda):
    """resize_area on a CUDA tensor equals the CPU's bit for bit: the same
    gathers, products and sums in the same order, one kernel each."""
    from opticalflowcontainer_tpu_torch.core.resize import resize_area, resize_nearest

    rng = np.random.default_rng(22)
    for shape, size in (((480, 640), (240, 320)), ((720, 1280, 3), (432, 768)),
                        ((60, 80), (96, 128))):
        img = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
        on_card = resize_area(img.to(cuda), size)
        assert on_card.device.type == "cuda"
        assert torch.equal(on_card.cpu(), resize_area(img, size))
        m = img > 128
        assert torch.equal(resize_nearest(m.to(cuda), size).cpu(), resize_nearest(m, size))


def _eval_pairs():
    from opticalflowcontainer_tpu_torch.eval.datasets import synthetic_eval_pairs

    return synthetic_eval_pairs(2, 128, 160)


def test_eval_farneback_runner_on_card_matches_cpu(cuda):
    """run_eval's farneback runner on two synthetic pairs at 128 x 160: the
    card (K1, K2) against the CPU, mean 1e-3 px and max 1e-2 px (chip_smoke
    phase 4's bars), and K1 and K2 launched (levels + 1) x 3 iterations
    times a pair."""
    from opticalflowcontainer_tpu_torch.eval.run_eval import _make_method

    card = _make_method("farneback", None, False, device=cuda)
    cpu = _make_method("farneback", None, False, device="cpu")
    per_pair = (fb._num_levels(128, 160, 3, 0.5) + 1) * 3
    for img1, img2, _, _ in _eval_pairs():
        k1.farneback_update.launches = k2.blur_solve.launches = 0
        on_card = card(img1, img2)
        assert k1.farneback_update.launches == k2.blur_solve.launches == per_pair
        d = np.abs(on_card - cpu(img1, img2))
        assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())


@pytest.mark.parametrize("method,launches", [("pwcnet", (4, 5)), ("neuflow", (2, 2))])
def test_eval_model_runner_on_card_matches_cpu(method, launches, cuda):
    """run_eval's pwcnet and neuflow runners (the packaged npz, or seeded
    weights where it is absent) on two synthetic pairs at 128 x 160: the
    card (K3, K4; cuDNN without TF32) against the CPU, bars relative to the
    flow's RMS as chip_smoke's, mean 1e-3 and max 5e-2, and the K3 / K4
    launches a pair."""
    from opticalflowcontainer_tpu_torch.eval.run_eval import _make_method

    card = _make_method(method, None, False, device=cuda)
    cpu = _make_method(method, None, False, device="cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for img1, img2, _, _ in _eval_pairs():
            k3.warp_bilinear.launches = k4.local_correlation.launches = 0
            on_card = card(img1, img2)
            assert (k3.warp_bilinear.launches, k4.local_correlation.launches) == launches
            on_cpu = cpu(img1, img2)
            rms = np.sqrt((on_cpu ** 2).mean())
            d = np.abs(on_card - on_cpu)
            assert d.mean() <= 1e-3 * rms and d.max() <= 5e-2 * rms, (d.mean(), d.max(), rms)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_eval_time_device_on_card(cuda):
    """--time-device on the card: a CUDA-graph or CUDA-event time, named."""
    import contextlib
    import io
    import json

    from opticalflowcontainer_tpu_torch.eval import run_eval

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_eval.main(["--method", "farneback,neuflow", "--n", "1",
                              "--quick", "--time-device"]) == 0
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["timer"] in ("cuda_graph", "cuda_events") for r in rows] == [True, True]
    assert all(r["device_ms_per_frame"] > 0 for r in rows)


# ------------------------------------------------ the junction pipeline
def _drawn_fishnet(shift=0, H=240, W=320, cell=24):
    """tests/test_launch.py's fishnet, drawn with the port's core/draw.py."""
    from opticalflowcontainer_tpu_torch.core.draw import line

    img = np.full((H, W + 64, 3), (180, 120, 60), np.uint8)
    for y in range(12, H, cell):
        line(img, (0, y), (W + 64, y), (30, 40, 50), 2)
    for x in range(12, W + 64, cell):
        line(img, (x, 0), (x, H), (30, 40, 50), 2)
    return np.ascontiguousarray(img[:, 32 - shift:32 - shift + W])


@pytest.mark.parametrize("rotated", [False, True])
def test_compiled_detector_matches_plain(rotated, cuda):
    """The compiled junction detector (host C++ built by the kernels' nvcc
    call) against the plain one: the same junctions, in the same order,
    within 1e-3 px, on the golden image and on a drawn fishnet; and on
    blurred random images, where the cells are what the threshold makes of
    noise."""
    import pathlib

    from opticalflowcontainer_tpu_torch.native import detect_junctions
    from opticalflowcontainer_tpu_torch.utils.png import imread

    golden = imread(str(pathlib.Path(__file__).parent / "data" / "fishnet_golden.png"))
    rng = np.random.default_rng(4)
    noise = rng.integers(0, 256, (90, 130, 3), dtype=np.uint8)
    noise = ((noise.astype(np.float32) + np.roll(noise, 1, 0) + np.roll(noise, 1, 1)) / 3
             ).astype(np.uint8)
    for img, area in ((golden, 26.0 ** 2), (_drawn_fishnet(), 22.0 ** 2), (noise, 12.0)):
        compiled = detect_junctions(img, grid_area=area, rotated=rotated)
        plain = detect_junctions(img, grid_area=area, rotated=rotated, force_python=True)
        assert compiled.shape == plain.shape
        if len(plain):
            assert np.abs(compiled - plain).max() <= 1e-3


def test_bringup_junction_on_card_recovers_translation(cuda):
    """bringup_junction with the compiled detector and Farneback on the card
    recovers the fishnet's 2 px a frame, K1 and K2 running on every pair."""
    from opticalflowcontainer_tpu_torch.runtime.launch import bringup_junction
    from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg

    bus, node, det = bringup_junction(grid_area=22.0 ** 2, device=cuda)
    node.vel.pixel_to_meter = 1.0
    vels = []
    bus.subscribe("/optical_flow/JUNCTION_velocity", lambda m: vels.append(m.x))
    k1.farneback_update.launches = 0
    for f in range(6):
        bus.publish("/camera/color/image_raw", ImageMsg(Header(float(f)), _drawn_fishnet(2 * f)))
    node.stop()
    assert len(vels) == 5 and abs(np.mean(vels) - 2.0) < 0.3, vels
    assert k1.farneback_update.launches == 5 * (fb._num_levels(240, 320, 2, 0.5) + 1) * 2


def test_adaptive_backend_on_card_matches_cpu(cuda):
    """make_adaptive_backend around Farneback: the card against the CPU at
    the port's parity bar (mean 1e-3, max 1e-2 px)."""
    from opticalflowcontainer_tpu_torch.runtime.adaptive import (
        AdaptiveParams, make_adaptive_backend)
    from opticalflowcontainer_tpu_torch.runtime.nodes import make_farneback_backend

    rng = np.random.default_rng(6)
    base = rng.uniform(0, 255, (100, 150)).astype(np.float32)
    prev, cur = base[:, :128], base[:, 2:130]
    params = AdaptiveParams(flow_median_ksize=3, flow_max_mag=50.0)
    got = make_adaptive_backend(make_farneback_backend(device=cuda), params)(prev, cur, 0.03)
    want = make_adaptive_backend(make_farneback_backend(device="cpu"), params)(prev, cur, 0.03)
    d = np.abs(got - want)
    assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())


def test_ingest_and_prefetch_on_card(cuda):
    """preprocess_frames on the card equals the CPU's within 1e-6 of the
    0-1 scale, and DevicePrefetcher yields the source's bytes in order."""
    from opticalflowcontainer_tpu_torch.core.ingest import preprocess_frames
    from opticalflowcontainer_tpu_torch.runtime.prefetch import DevicePrefetcher

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    got = preprocess_frames(frames, out_hw=(24, 32), to_gray=True, device=cuda)
    want = preprocess_frames(frames, out_hw=(24, 32), to_gray=True, device="cpu")
    assert got.device.type == "cuda"
    assert (got.cpu() - want).abs().max() <= 1e-6
    items = [{"img": f, "i": i} for i, f in enumerate(frames)]
    out = list(DevicePrefetcher(iter(items), device=cuda))
    assert [o["i"] for o in out] == [0, 1, 2]
    assert all(np.array_equal(o["img"].cpu().numpy(), f) for o, f in zip(out, frames))


@pytest.fixture
def one_rank_mesh(cuda, tmp_path):
    """A 1x1 ("data", "model") mesh over one NCCL rank on the card."""
    from opticalflowcontainer_tpu_torch import parallel

    parallel.init_distributed(0, 1, f"file://{tmp_path}/store", timeout_s=60)
    try:
        yield parallel.make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def _pairs(cuda, B=2, H=96, W=128):
    rng = np.random.default_rng(12)
    base = rng.uniform(0, 255, (B, H + 4, W + 4)).astype(np.float32)
    prev = torch.from_numpy(base[:, 2:2 + H, 2:2 + W].copy()).to(cuda)
    cur = torch.from_numpy(base[:, 1:1 + H, 3:3 + W].copy()).to(cuda)
    return prev, cur


def test_sharded_legs_on_a_one_rank_nccl_mesh(one_rank_mesh, cuda):
    """The three inference legs equal the unsharded calls bit for bit on a
    1x1 NCCL mesh, K1/K2 launching inside each as in the unsharded call."""
    import functools

    from opticalflowcontainer_tpu_torch import parallel

    mesh = one_rank_mesh
    assert torch.distributed.get_backend(mesh.get_group("data")) == "nccl"
    prev, cur = _pairs(cuda)
    flow_fn = functools.partial(fb.farneback_batched, device=cuda)
    n0 = k1.farneback_update.launches
    want = flow_fn(prev, cur)
    per_call = k1.farneback_update.launches - n0
    flow, mean_u = parallel.make_sharded_flow_fn(flow_fn, mesh)(prev, cur)
    assert k1.farneback_update.launches - n0 == 2 * per_call > 0
    assert torch.equal(flow, want)
    assert float(mean_u) == pytest.approx(float(want[..., 0].mean()), rel=1e-5)
    assert torch.equal(parallel.make_spatial_sharded_flow_fn(flow_fn, mesh)(prev, cur), want)
    state = fb.farneback_stream_planes(prev, device=cuda)
    step, _ = fb.farneback_stream_step(state, cur, device=cuda)
    du, state2 = parallel.make_sharded_stream_fn(mesh)(state, cur)
    assert torch.equal(du, step[..., 0].mean(dim=(1, 2)))
    assert [s.shape for s in state2] == [s.shape for s in state]


def test_sharded_train_step_on_a_one_rank_nccl_mesh(one_rank_mesh, cuda):
    """The first loss of the sharded step equals train_step's from the same
    parameters (one rank: the all-reduce sums one gradient)."""
    import copy

    from opticalflowcontainer_tpu_torch import parallel
    from opticalflowcontainer_tpu_torch.parallel import dryrun
    from opticalflowcontainer_tpu_torch.tools.train_flow import make_affine_batch

    model = dryrun.raft_small(None, cuda)
    twin = copy.deepcopy(model)
    state = parallel.TrainState(model, parallel.make_optimizer(dict(model.named_parameters())))
    plain = parallel.TrainState(twin, parallel.make_optimizer(dict(twin.named_parameters())))
    batch = make_affine_batch(np.random.default_rng(5), 2, 64, 64)
    step = parallel.make_sharded_train_step(state, one_rank_mesh, iters=2)
    state, loss = step(state, batch)
    plain, want = parallel.train_step(plain, batch, iters=2)
    assert loss.device.type == "cuda" and float(loss) == float(want)
    assert state.step == plain.step == 1


def test_two_ranks_on_one_card_match_one_rank(cuda):
    """Two spawned ranks sharing the card over gloo, meshes (2, 1) and
    (1, 2): each leg's blocks rebuild the unsharded result."""
    from opticalflowcontainer_tpu_torch.parallel import dryrun

    prev, cur = _pairs(cuda)
    want = fb.farneback_batched(prev, cur, device=cuda).cpu().numpy()
    state = fb.farneback_stream_planes(prev, device=cuda)
    step, _ = fb.farneback_stream_step(state, cur, device=cuda)
    du = step[..., 0].mean(dim=(1, 2)).cpu().numpy()
    p, c = prev.cpu().numpy(), cur.cpu().numpy()
    payload = {"meshes": [(2, 1), (1, 2)],
               "flow": {"kw": {}, "prev": p, "cur": c},
               "spatial": {"kw": {}, "prev": p, "cur": c},
               "stream": {"kw": {}, "g0": p, "g1": c}}
    ranks = dryrun.spawn(2, "infer", payload, cpu=False, backend="gloo",
                         threads=None, timeout_s=300)
    for i, (data, model) in enumerate(payload["meshes"]):
        firsts = [ranks[r * model][i] for r in range(data)]
        np.testing.assert_allclose(np.concatenate([f["flow"] for f in firsts]), want, atol=1e-5)
        np.testing.assert_allclose(np.concatenate([f["spatial"] for f in firsts]), want, atol=1e-5)
        np.testing.assert_allclose(np.concatenate([f["du"] for f in firsts]), du, atol=1e-5)
        assert all(r[i]["launches"]["flow"]["farneback_update"] > 0 for r in ranks)


def test_compiled_decoders_equal_the_plain_ones(cuda):
    """The compiled JPEG decoder and PNG unfilter (host C++ built by the
    kernels' nvcc call) equal their plain forms byte for byte on the
    committed fixtures: every frame of the 640x480 Motion-JPEG AVI, the
    4:4:4 JPEG with restart markers and the PNG of all five row filters."""
    import pathlib

    from opticalflowcontainer_tpu_torch.utils import avi, imcodec

    data = pathlib.Path(__file__).resolve().parent / "data"
    compiled = avi.AviReader(str(data / "synthetic_640x480_mjpeg.avi"))
    plain = avi.AviReader(str(data / "synthetic_640x480_mjpeg.avi"),
                          force_python=True)
    assert len(compiled) == len(plain) == 16
    for i in range(len(plain)):
        np.testing.assert_array_equal(compiled.frame(i), plain.frame(i))
    for name in ("restart_444.jpg", "mixed_filters_640x480.png"):
        raw = (data / name).read_bytes()
        np.testing.assert_array_equal(imcodec.imdecode(raw),
                                      imcodec.imdecode(raw, force_python=True))
        assert imcodec.imdecode(raw[:len(raw) // 2]) is None


def test_packaged_pwcnet_on_the_card_matches_the_cpu(cuda):
    """The packaged ``pwcnet_synth.npz`` loaded on the card serves the
    first easy fishnet pair at 640x480 as the port does on the CPU, at
    chip_smoke phase 28's bars: with fp32 convolutions mean 1e-3 px, max
    5e-2 px (K3/K4 against their plain versions, fp32 sums in another
    order; the max allows a masked-warp gate flip); the served flow (the
    model holds fp32 convolutions) within 1e-2 px mean of fp32 with
    PyTorch's defaults switched off; K3 4 and K4 5 launches a call."""
    from opticalflowcontainer_tpu_torch.eval.datasets import fishnet_eval_pairs
    from opticalflowcontainer_tpu_torch.models import convert

    card, cpu = convert.load_pwcnet_synth(cuda), convert.load_pwcnet_synth("cpu")
    assert card is not None and cpu is not None, "pwcnet_synth.npz is absent"
    (img1, img2, _, _), = fishnet_eval_pairs(1)
    with torch.inference_mode():
        want = pwcnet.estimate(cpu, img1, img2)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            before = (k3.warp_bilinear.launches, k4.local_correlation.launches)
            fp32 = pwcnet.estimate(card, img1, img2)
            torch.cuda.synchronize()
            after = (k3.warp_bilinear.launches, k4.local_correlation.launches)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        served = pwcnet.estimate(card, img1, img2)
    assert (after[0] - before[0], after[1] - before[1]) == (4, 5)
    assert fp32.shape == (480, 640, 2) and bool(torch.isfinite(fp32).all())
    d = (fp32.cpu() - want).abs()
    assert float(d.mean()) <= 1e-3 and float(d.max()) <= 5e-2
    assert float((served - fp32).abs().mean()) <= 1e-2


# ------------------------------------------------- the frame upload (core.device)

def _clip(seed, shape=(7, 2, 1080, 1920)):
    """A uint8 clip [T, ..., H, W] in pageable host memory (the 1080p one is
    29.03 MB): noise that moves a pixel right and down a frame."""
    T, H, W = shape[0], shape[-2], shape[-1]
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, shape[1:-2] + (H + T, W + T), dtype=np.uint8)
    return np.stack([base[..., t:t + H, t:t + W] for t in range(T)])


def _as_input(kind, clip, cuda):
    if kind == "numpy":
        return clip
    if kind == "numpy_strided":  # the cameras interleaved on the last axis
        return np.moveaxis(np.ascontiguousarray(np.moveaxis(clip, 1, -1)), -1, 1)
    t = torch.from_numpy(clip)
    return {"tensor": t, "pinned": t.pin_memory(), "cuda": t.to(cuda)}[kind]


@pytest.mark.parametrize("kind,staged", [("numpy", 1), ("numpy_strided", 1),
                                         ("tensor", 1), ("pinned", 1), ("cuda", 0)])
def test_staged_upload_equals_the_pageable_one_at_1080p(kind, staged, cuda):
    """The 1080p clip's frames and ``farneback_clip``'s flows, bit for bit
    the pageable upload's (``torch.from_numpy(...).to(cuda)``, the route
    before the staging); host arrays, pinned ones too, are staged once a
    clip call, a CUDA tensor never."""
    clip = _clip(0)
    x = _as_input(kind, clip, cuda)
    pageable = torch.from_numpy(clip).to(cuda)
    frames = fb._frames(x, cuda)
    want = fb.farneback_clip(pageable, device=cuda)
    before = (dv.upload.staged, dv.upload.staged_bytes)
    got = fb.farneback_clip(x, device=cuda)
    counted = (dv.upload.staged - before[0], dv.upload.staged_bytes - before[1])
    torch.cuda.synchronize()
    assert frames.dtype == torch.float32 and torch.equal(frames, pageable.float())
    assert torch.equal(got, want)
    assert counted == (staged, staged * clip.nbytes)


@pytest.mark.parametrize("kind", ["numpy", "pinned"])
@pytest.mark.parametrize("shape", [(7, 720, 1280), (7, 2, 1080, 1920)])
def test_caller_may_overwrite_its_frames_once_the_call_returns(shape, kind, cuda):
    """A caller with one buffer (a decoder's ring; a numpy array or a pinned
    tensor) fills it, calls, and fills it again at once, while the card
    still sleeps ahead of the DMAs: every call's flow is the flow of the
    frames it was given (each call's pinned block is still queued when the
    next call asks for one)."""
    clips = [_clip(seed, shape) for seed in (1, 2, 3)]
    want = [fb.farneback_clip(torch.from_numpy(c).to(cuda), device=cuda)
            for c in clips]
    buf = np.empty_like(clips[0])
    if kind == "pinned":
        buf = torch.from_numpy(buf).pin_memory()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream ahead of the copies
    got = []
    for c in clips:
        buf[...] = c if kind == "numpy" else torch.from_numpy(c)
        got.append(fb.farneback_clip(buf, device=cuda))
    buf[...] = 0
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("helpers", [0, 3, 7])
def test_the_built_host_gather_reads_any_strides(helpers, cuda):
    """``ofc_host_gather`` as nvcc's build holds it: the 1080p clip's two
    cameras interleaved on the last axis, and a crop of a 720p clip, into
    pinned memory, by the caller alone or with helpers, equal the arrays'
    C-order bytes."""
    rng = np.random.default_rng(helpers)
    wide = np.moveaxis(rng.integers(0, 256, (7, 1080, 1920, 2), dtype=np.uint8), -1, 1)
    crop = rng.integers(0, 256, (7, 720, 1280), dtype=np.uint8)[:, 7:700, 3:1201]
    for x in (wide, crop):
        out = torch.empty(x.shape, dtype=torch.uint8, pin_memory=True)
        dv.host_gather(out, torch.from_numpy(x), helpers=helpers)
        np.testing.assert_array_equal(out.numpy(), x)


@pytest.mark.parametrize("strided", [False, True])
def test_two_threads_on_two_streams_upload_their_own_frames(strided, cuda):
    """Two threads, each on its own stream with its own buffer (strided:
    the frames' rows every other one of a wider array), upload four
    [7, 1080, 1920] clips at once through ``_frames``, sharing the helper
    pool and the pinned blocks' cache.  Each gets its own frames, and all
    eight uploads are counted."""
    clips = {k: [_clip(10 * k + i, (7, 1080, 1920)) for i in range(4)] for k in (0, 1)}
    got = {0: [], 1: []}
    errors = []
    before = dv.upload.staged

    def work(k):
        try:
            stream = torch.cuda.Stream(cuda)
            wide = np.empty((7, 2 * 1080, 1920), np.uint8)
            buf = wide[:, ::2] if strided else wide[:, :1080]
            with torch.cuda.stream(stream):
                for c in clips[k]:
                    buf[...] = c
                    got[k].append(fb._frames(buf, cuda))
                wide[...] = 0
            stream.synchronize()
        except BaseException as e:  # handed to the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert dv.upload.staged - before == 8
    for k in (0, 1):
        assert len(got[k]) == 4
        for frames, c in zip(got[k], clips[k]):
            assert torch.equal(frames.cpu(), torch.from_numpy(c).float())


def test_the_upload_never_synchronizes_a_stream(cuda):
    """Under the profiler, the 1080p clip call's ``ofc.farneback.upload``
    span holds one host-to-device copy and no stream or device
    synchronization."""
    from torch.profiler import ProfilerActivity, profile

    clip = _clip(4)
    fb.farneback_clip(clip, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fb.farneback_clip(clip, device=cuda)
        torch.cuda.synchronize()
    events = prof.events()
    upload, = [e.time_range for e in events if e.name == spans.FARNEBACK_UPLOAD]
    inside = [e.name for e in events
              if upload.start <= e.time_range.start <= upload.end]
    assert not {"cudaStreamSynchronize", "cudaDeviceSynchronize"} & set(inside)
    assert inside.count("cudaMemcpyAsync") == 1
