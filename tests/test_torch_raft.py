"""The port's RAFT slice held against the JAX package on the CPU: ``unfold``,
the all-pairs volume, its pyramid and the windowed lookup (radii 3 and 4, a
1-pixel and an empty coarsest level), RAFT-small and RAFT (large) with the
packaged npz (the net's per-iteration flows, ``final_only``, ``iters=0``
and ``estimate`` at 64x64 and 50x70), batched == single, the converter and
the demo's RAFT backends.  Inputs are made with numpy from a seed.

Tolerances: the volume, pyramid and lookup 1e-5 of their scale (fp32 sums
in another order; measured ~1e-7 of it).  The whole net and ``estimate``:
the flow within 1e-5 px mean and 2e-4 px max of JAX's (measured 2.6e-7 to
4.8e-7 px mean and up to 2.4e-6 px max at 2-3 iterations on flows of ~1.7
px RMS: fp32 convolutions summed in another order, which the recurrence
carries from step to step).
"""
import jax
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import raft as jraft
from opticalflowcontainer_tpu.ops import allpairs as jallpairs
from opticalflowcontainer_tpu.ops import unfold as junfold  # the function
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import raft as traft
from opticalflowcontainer_tpu_torch.ops import allpairs
from opticalflowcontainer_tpu_torch.ops.unfold import unfold
from opticalflowcontainer_tpu_torch.runtime import demo
from test_torch_threads import one_torch_thread  # noqa: F401

OP_TOL = 1e-5
MEAN_PX, MAX_PX = 1e-5, 2e-4
# (loader pair, npz file, keys, parameters) of the two packaged checkpoints
PACKAGED = {
    "small": ((jraft.load_raft_small_synth, convert.load_raft_small_synth),
              "raft_small_synth.npz", 106, 990_162),
    "large": ((jraft.load_raft_synth, convert.load_raft_synth),
              "raft_large_synth.npz", 94, 5_254_656),
}


@pytest.fixture(scope="module", params=["small", "large"])
def nets(request):
    """(name, JAX (model, params), the port's model on the CPU)."""
    (jload, tload), fname, _, _ = PACKAGED[request.param]
    jm, tm = jload(), tload(device="cpu")
    assert jm is not None and tm is not None, f"packaged {fname} missing"
    return request.param, jm, tm


def _smooth_pair(rng, H, W, shift=(1, 2)):
    """A smooth random image in [0, 1] and itself rolled by ``shift``
    (rows, cols), so the nets see structure to match."""
    a = rng.uniform(0, 1, (H + 8, W + 8, 3)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for axis in (0, 1):
        a = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), axis, a)
    a = a[4:4 + H, 4:4 + W]
    a = ((a - a.min()) / (a.max() - a.min())).astype(np.float32)
    return a, np.roll(a, shift, (0, 1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _assert_close(got, want, tol):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _assert_flow_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() <= MEAN_PX and d.max() <= MAX_PX, (d.mean(), d.max())


@pytest.mark.parametrize("k,padding", [(1, None), (3, None), (5, None)])
def test_unfold_matches_jax(k, padding, rng):
    """The port's [B, C, k*k, H, W] stack against the reference's
    [B, H, W, k*k, C], patch index dy * k + dx, zero padded."""
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    want = np.asarray(junfold(x, k, padding)).transpose(0, 4, 3, 1, 2)
    got = unfold(_nchw(x), k, padding).numpy()
    np.testing.assert_array_equal(got, want)


def _volume(rng, B, h, w, C):
    f1 = rng.standard_normal((B, h, w, C)).astype(np.float32)
    f2 = rng.standard_normal((B, h, w, C)).astype(np.float32)
    return f1, f2


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9)], ids=["1px-coarsest", "empty-coarsest"])
def test_volume_and_pyramid_match_jax(h, w, rng):
    """64x64 and 56x72 inputs give 8x8 and 7x9 features: coarsest levels
    1 x 1 and 0 x 1."""
    f1, f2 = _volume(rng, 2, h, w, 32)
    vol = allpairs.all_pairs_correlation(_nchw(f1), _nchw(f2))
    pyr = allpairs.corr_pyramid(vol, 4)
    for b in range(2):
        jvol = jallpairs.all_pairs_correlation(f1[b], f2[b])
        jpyr = jallpairs.corr_pyramid(jvol, 4)
        assert [tuple(p.shape[1:]) for p in pyr] == [tuple(p.shape) for p in jpyr]
        for p, jp in zip(pyr, jpyr):
            if jp.size:
                _assert_close(p[b].numpy(), np.asarray(jp), OP_TOL)


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("h,w", [(8, 8), (7, 9)], ids=["1px-coarsest", "empty-coarsest"])
def test_corr_lookup_matches_jax(h, w, radius, rng):
    """Flows that put taps off every level (and x = 0.3 on the 1-pixel
    level, where grid_sample's align-corners read would take v, not 0.7
    v): channels level-major, then row-major over (dy, dx)."""
    f1, f2 = _volume(rng, 2, h, w, 16)
    flow = (rng.standard_normal((2, h, w, 2)) * 4.0).astype(np.float32)
    flow[:, 0, 0] = (0.3, 0.0)
    vol = allpairs.all_pairs_correlation(_nchw(f1), _nchw(f2))
    pyr = allpairs.corr_pyramid(vol, 4)
    got = allpairs.corr_lookup(pyr, _nchw(flow), radius).numpy()
    assert got.shape == (2, 4 * (2 * radius + 1) ** 2, h, w)
    for b in range(2):
        jpyr = jallpairs.corr_pyramid(jallpairs.all_pairs_correlation(f1[b], f2[b]), 4)
        want = np.asarray(jallpairs.corr_lookup(jpyr, flow[b], radius))
        _assert_close(got[b], want.transpose(2, 0, 1), OP_TOL)


def test_corr_lookup_one_pixel_level_weights(rng):
    """At a 1 x 1 level a sample at x = 0.3 reads 0.7 v (its right tap is
    off the level), as the reference's zero-outside taps."""
    v = np.float32(2.5)
    pyr = [torch.full((1, 1, 1, 1, 1), float(v))]
    flow = torch.tensor([0.3, 0.0]).reshape(1, 2, 1, 1)
    out = allpairs.corr_lookup(pyr, flow, 0)
    np.testing.assert_allclose(out.numpy().ravel(), [0.7 * v], rtol=1e-6)


def _packed(rng, B, h, w, levels=4):
    vol = torch.from_numpy(rng.standard_normal((B, h, w, h, w)).astype(np.float32))
    return allpairs.pack_pyramid(allpairs.corr_pyramid(vol, levels))


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("h,w", [(8, 8), (7, 9)], ids=["1px-coarsest", "empty-coarsest"])
def test_lookup_cpu_route_is_the_plain_version_with_no_launch(h, w, radius, rng):
    """A CPU tensor takes ``_lookup_packed`` (K6's plain version) as it is:
    one call counted, no launch."""
    packed = _packed(rng, 2, h, w)
    flow = torch.from_numpy((rng.standard_normal((2, 2, h, w)) * 4).astype(np.float32))
    calls, launches = allpairs.lookup_packed.calls, allpairs.lookup_packed.launches
    got = allpairs.lookup_packed(packed, flow, radius)
    assert torch.equal(got, allpairs._lookup_packed(packed, flow, radius))
    assert allpairs.lookup_packed.calls == calls + 1
    assert allpairs.lookup_packed.launches == launches


def test_lookup_wrapper_rejects_what_it_does_not_take(rng):
    """Every route: flow [B, 2, H, W] beside flat [B, H*W, K] on its device,
    the levels packed side by side, a radius >= 0.  The card's route
    besides: fp32, a contiguous volume, radius <= 4, 1..8 levels, sides
    below 2^16, B <= 65535."""
    packed = _packed(rng, 2, 8, 8)
    flow = torch.zeros(2, 2, 8, 8)
    lookup = allpairs.lookup_packed
    with pytest.raises(ValueError, match=r"\[B, 2, H, W\]"):
        lookup(packed, flow[:, :1], 4)
    with pytest.raises(ValueError, match="packed volume must be"):
        lookup(packed, torch.zeros(2, 2, 8, 9), 4)
    with pytest.raises(ValueError, match="packed volume must be"):
        lookup(packed, flow[:1], 4)
    with pytest.raises(ValueError, match="side by side"):
        lookup(packed._replace(sizes=packed.sizes[1:]), flow, 4)
    with pytest.raises(ValueError, match="fill"):
        lookup(packed._replace(sizes=packed.sizes[:-1] + ((84, 1, 2),)), flow, 4)
    with pytest.raises(ValueError, match=">= 0"):
        lookup(packed, flow, -1)
    check = allpairs._check_kernel
    check(packed, flow, 4)  # RAFT's
    with pytest.raises(TypeError, match="float32"):
        check(packed._replace(flat=packed.flat.double()), flow, 4)
    with pytest.raises(ValueError, match="contiguous"):
        check(packed._replace(flat=packed.flat.transpose(0, 1)), flow, 4)
    with pytest.raises(ValueError, match="radius up to 4"):
        check(packed, flow, 5)
    with pytest.raises(ValueError, match="1..8 levels"):
        check(packed._replace(sizes=()), flow, 4)
    with pytest.raises(ValueError, match="1..8 levels"):
        check(packed._replace(sizes=((0, 1, 1),) * 9), flow, 4)
    with pytest.raises(ValueError, match="side exceeds"):
        check(packed._replace(sizes=((0, 1, 65536),)), flow, 4)
    with pytest.raises(ValueError, match="launch grid"):
        check(packed, torch.zeros(65536, 2, 1, 1), 4)


def test_a_sample_floor_lies_in_the_staged_window():
    """K6 stages a level's window from floor(c) - r, c = cx 2^-l, over
    2r+3 columns: a sample at fl(c + dx) floors to floor(c) + dx or one
    above (never below, as floor(c) + dx is a float), and its right tap
    one further.  Both cases occur, near integers from below."""
    rng = np.random.default_rng(6)
    below = np.nextafter(np.arange(-300, 300, dtype=np.float32), np.float32(-np.inf))
    c = np.concatenate([rng.uniform(-300, 300, 20000).astype(np.float32), below])
    shifts = set()
    for dx in range(-4, 5):
        x = (c + np.float32(dx)).astype(np.float32)
        shifts.update(np.unique(np.floor(x) - np.floor(c) - dx).tolist())
    assert shifts == {0.0, 1.0}


def _jax_apply(jm, jp, a, b, iters, final_only=False):
    apply = jax.jit(jm.apply, static_argnums=(3,), static_argnames=("final_only",))
    return np.asarray(apply(jp, a, b, iters, final_only=final_only))


def test_net_flows_match_jax(nets, rng):
    """Each of 2 iterations' upsampled flows at 64x64 (1 x 1 coarsest
    level)."""
    name, (jm, jp), tm = nets
    iters = 2
    a, b = _smooth_pair(rng, 64, 64)
    want = _jax_apply(jm, jp, a, b, iters)  # [iters, H, W, 2]
    with torch.inference_mode():
        got = tm(_nchw(a[None]), _nchw(b[None]), iters=iters)
    assert got.shape == (iters, 1, 2, 64, 64)
    _assert_flow_close(got[:, 0].permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("H,W", [(64, 64), (50, 70)])
def test_estimate_matches_jax(nets, H, W, rng):
    """The resize-to-8 contract at 64x64 and at 50x70 (56x72 inside: a 7x9
    feature map, an empty coarsest level)."""
    name, (jm, jp), tm = nets
    a, b = _smooth_pair(rng, H, W)
    want = np.asarray(jraft.estimate(jm, jp, a, b, iters=3))
    got = traft.estimate(tm, a, b, iters=3)
    assert got.shape == (H, W, 2) and got.dtype == torch.float32
    _assert_flow_close(got.numpy(), want)
    assert np.sqrt((want ** 2).mean()) > 0.5  # the flow is not trivially 0


def test_final_only_iters_zero_and_batch(nets, rng):
    """``final_only`` is the last of the stacked flows; ``iters=0`` gives
    the upsampled zero flow (JAX's, for RAFT-large's convex upsampler);
    a batch of 2 equals the single calls (instance norm per image)."""
    name, (jm, jp), tm = nets
    a, b = _smooth_pair(rng, 48, 56)
    x1, x2 = _nchw(a[None]), _nchw(b[None])
    with torch.inference_mode():
        stacked = tm(x1, x2, iters=2)
        final = tm(x1, x2, iters=2, final_only=True)
        zero = tm(x1, x2, iters=0, final_only=True)
    torch.testing.assert_close(final, stacked[-1], rtol=0, atol=0)
    want0 = _jax_apply(jm, jp, a, b, 0, final_only=True)
    _assert_flow_close(zero[0].permute(1, 2, 0).numpy(), want0)
    c, d = _smooth_pair(rng, 48, 56, shift=(-2, 1))
    pair = traft.estimate(tm, np.stack([a, c]), np.stack([b, d]), iters=2)
    for i, (p, q) in enumerate(((a, b), (c, d))):
        one = traft.estimate(tm, p, q, iters=2)
        np.testing.assert_allclose(pair[i].numpy(), one.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["small", "large"])
def test_converter_uses_every_key_once(name):
    """The loader maps every npz key to one parameter of the port's module
    (``flax_to_torch_state_dict`` raises on a key left over or a parameter
    left unfilled) and returns None without the file."""
    (_, tload), fname, n_keys, n_params = PACKAGED[name]
    flat = convert.load_flat_npz(convert.WEIGHTS_DIR / fname)
    assert len(flat) == n_keys
    model = traft.RAFTSmall() if name == "small" else traft.RAFT()
    sd = convert.flax_to_torch_state_dict(flat, model)
    assert len(sd) == n_keys == len(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == n_params
    assert sum(p.numel() for p in tload(device="cpu").parameters()) == n_params


def test_loaders_return_none_without_weights(tmp_path, monkeypatch):
    monkeypatch.setattr(convert, "WEIGHTS_DIR", tmp_path)
    assert convert.load_raft_small_synth(device="cpu") is None
    assert convert.load_raft_synth(device="cpu") is None


@pytest.mark.parametrize("model", ["raft", "raft_large"])
def test_demo_raft_on_the_cpu(model, capsys):
    """The demo's self-check with the RAFT backends (the fused model
    stream, 8 iterations) on the CPU at 96x128; without the npz it prints
    so and returns 1."""
    argv = ["--cpu", "--model", model, "--frames", "10", "--width", "128",
            "--height", "96", "--fps", "100"]
    r = demo.run(argv)
    out = capsys.readouterr().out
    assert r["exit_code"] == 0 and r["frames_failed"] == 0, out
    assert "velocity error" in out and "OK" in out


def test_demo_without_weights_returns_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(convert, "WEIGHTS_DIR", tmp_path)
    assert demo.main(["--cpu", "--model", "raft"]) == 1
    assert "no packaged weights for raft" in capsys.readouterr().out


def test_fp32_convolutions_counts_threads_and_restores():
    """The guard sets cuDNN to fp32 with timed algorithms while any block
    is open, in any thread, and restores the caller's settings after the
    last one closes."""
    import threading

    from opticalflowcontainer_tpu_torch.models.common import fp32_convolutions

    cudnn = torch.backends.cudnn
    before = (cudnn.benchmark, cudnn.allow_tf32)
    inside, release = threading.Event(), threading.Event()
    seen = []

    def worker():
        with fp32_convolutions():
            inside.set()
            release.wait(10)
            seen.append((cudnn.benchmark, cudnn.allow_tf32))

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert inside.wait(10)
        with fp32_convolutions():
            assert (cudnn.benchmark, cudnn.allow_tf32) == (True, False)
        # the worker's block is still open
        assert (cudnn.benchmark, cudnn.allow_tf32) == (True, False)
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive() and seen == [(True, False)]
    assert (cudnn.benchmark, cudnn.allow_tf32) == before
