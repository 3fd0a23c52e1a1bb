"""The port's three Farneback kernels, K1 ``farneback_update``, K2
``blur_solve`` and K5 ``farneback_prep``: K1 and K2 held against the JAX
package on the CPU; K5's wrapper, its launch arithmetic and its CPU path
(K5 replaces no TPU kernel: its plain version is ``_level_planes``'
operations, which ``tests/test_torch_farneback.py`` holds against JAX
through ``poly_exp`` and the flow).

On the CPU each wrapper runs its kernel's plain PyTorch version, which is
what these tests compare; the CUDA kernels themselves are compared with the
same plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
Inputs are made with numpy from a seed and handed to both frameworks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opticalflowcontainer_tpu.classical.farneback as jfb
from opticalflowcontainer_tpu.ops.blockwarp import block_warp_farneback_update
from opticalflowcontainer_tpu.ops.solve2x2 import blur_solve_2x2
from opticalflowcontainer_tpu_torch.classical import farneback as tfb
from opticalflowcontainer_tpu_torch.core.resize import _taps
from opticalflowcontainer_tpu_torch.ops import farneback_prep as k5
from opticalflowcontainer_tpu_torch.ops import farneback_update as k1
from opticalflowcontainer_tpu_torch.ops import solve2x2 as k2


def _planes(rng, B, H, W):
    return rng.normal(size=(B, 5, H, W)).astype(np.float32)


def _normal_eq(rng, B, H, W):
    """Normal-equation planes shaped like the real ones: G positive definite."""
    a, b, c = (rng.normal(size=(B, H, W)).astype(np.float32) for _ in range(3))
    return np.stack([a * a + 0.5, 0.3 * a * b, b * b + 0.5, c, a * c], axis=1)


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("flow", ["zero", "oob", "smooth"])
def test_update_plain_matches_jax_update_matrices(flow, rng):
    """K1's plain version == the reference's exact-gather `_update_matrices`
    (channel-last, tap-packed).  "oob" puts many taps outside the level, so
    the frame-0-only branch is covered.  Tolerance 1e-5 relative to the
    planes' scale: both are fp32 with the same operation order."""
    B, H, W = 2, 40, 56
    R0, R1 = _planes(rng, B, H, W), _planes(rng, B, H, W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if flow == "zero":
        u = v = np.zeros((B, H, W), np.float32)
    elif flow == "oob":
        u = rng.uniform(-8, 8, (B, H, W)).astype(np.float32)
        v = rng.uniform(-8, 8, (B, H, W)).astype(np.float32)
    else:
        u = np.broadcast_to(1.7 + np.sin(yy / 7.0), (B, H, W)).astype(np.float32)
        v = np.broadcast_to(-0.6 + 0.5 * np.cos(xx / 9.0), (B, H, W)).astype(np.float32)
    want = np.asarray(jfb._update_matrices(
        jnp.asarray(R0.transpose(0, 2, 3, 1)),
        jfb._pack_taps(jnp.asarray(R1.transpose(0, 2, 3, 1))),
        jnp.asarray(np.stack([u, v], -1))))
    got = k1.farneback_update(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in (R0, R1, u, v))).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_update_plain_matches_pallas_kernel_interpret(rng):
    """K1's plain version == the TPU kernel itself (interpret mode, fp32
    planes and output) on flow within the kernel's slack, where the block
    warp samples exactly.  The padded R1 the TPU kernel wants is the port's
    R1 replicate-padded.  Tolerance 1e-4 of M's scale, the bound the
    reference's own fused-vs-unfused test uses: the TPU kernel samples with
    separable select-accumulates over a bf16x3-split patch, another fp32
    rounding order (measured ~1.5e-5)."""
    B, H, W = 2, 64, 256
    pad_y, pad_x = 40, 192
    R0, R1 = _planes(rng, B, H, W), _planes(rng, B, H, W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = np.broadcast_to(2.2 + 0.8 * np.sin(2 * np.pi * yy / H), (B, H, W))
    v = np.broadcast_to(-1.3 + 0.6 * np.cos(2 * np.pi * xx / W), (B, H, W))
    u, v = u.astype(np.float32), v.astype(np.float32)
    r1p = np.pad(R1, ((0, 0), (0, 0), (pad_y, pad_y), (pad_x, pad_x)), mode="edge")
    want = np.asarray(block_warp_farneback_update(
        jnp.asarray(R0), jnp.asarray(r1p), jnp.asarray(u), jnp.asarray(v),
        img_hw=(H, W), ramp=tuple(float(r) for r in k1.BORDER_RAMP),
        block=(32, 128), slack=2, pad=(pad_y, pad_x), interpret=True,
        realign="roll", phases=2, select="roll", out_dtype=jnp.float32))
    got = k1.farneback_update(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in (R0, R1, u, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_border_weight_matches_jax():
    for H, W in ((40, 56), (7, 9), (3, 12)):
        np.testing.assert_array_equal(
            k1.border_weight(H, W), jfb._border_weight(H, W, jfb._BORDER_RAMP))


def test_update_wrapper_rejects_what_the_kernel_does_not_take(rng):
    R = torch.from_numpy(_planes(rng, 1, 8, 8))
    uv = torch.zeros(1, 8, 8)
    with pytest.raises(TypeError, match="float32"):
        k1.farneback_update(R.double(), R, uv, uv)
    with pytest.raises(ValueError, match="must be"):
        k1.farneback_update(R, R, torch.zeros(1, 8, 9), uv)
    with pytest.raises(ValueError, match="contiguous"):
        k1.farneback_update(R, R.transpose(2, 3), uv, uv)
    with pytest.raises(ValueError, match="R1"):
        k1.farneback_update(R, R[:, :, :4], uv, uv)


def test_update_cpu_path_counts_no_launch(rng):
    R = torch.from_numpy(_planes(rng, 1, 8, 8))
    uv = torch.zeros(1, 8, 8)
    before = k1.farneback_update.launches
    k1.farneback_update(R, R, uv, uv)
    assert k1.farneback_update.launches == before


# ---------------------------------------------------------------- K2

@pytest.mark.parametrize("winsize,gaussian", [(15, False), (15, True),
                                              (41, False), (9, True)])
def test_blur_solve_plain_matches_jax_solve(winsize, gaussian, rng,
                                            monkeypatch):
    """K2's plain version == the reference's `_solve_flow_planes` with fp32
    M and its XLA form (SOLVE_FUSE off), including winsizes above the TPU
    kernel's halo limit.  Tolerance 1e-5 relative: the reference blurs with
    border-folded matmuls, the port with shifted-slice sums (other fp32
    summation order)."""
    monkeypatch.setattr(jfb, "SOLVE_FUSE", False)
    M = _normal_eq(rng, 2, 45, 70)
    ue, ve = jfb._solve_flow_planes(jnp.asarray(M), winsize, gaussian)
    u, v = k2.blur_solve(torch.from_numpy(M), winsize, gaussian)
    for got, want in ((u, ue), (v, ve)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("gaussian", [False, True])
def test_blur_solve_plain_matches_pallas_kernel_interpret(gaussian, rng):
    """K2's plain version == the TPU kernel (interpret mode) to the TPU
    kernel's bf16-tap precision (ops/solve2x2.py: bf16 x bf16 -> fp32 blur
    matmuls), the same 2e-2 bound the reference's own test uses."""
    M = _normal_eq(rng, 2, 96, 256)
    u_t, v_t = blur_solve_2x2(jnp.asarray(M), winsize=15, gaussian=gaussian,
                              block=(48, 256), interpret=True)
    u, v = k2.blur_solve(torch.from_numpy(M), 15, gaussian)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_t), atol=2e-2)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_t), atol=2e-2)


@pytest.mark.parametrize("r,limit,shape,tile", [
    (7, 232448, (6, 720, 1280), (32, 112)),  # winsize 15, the clip: largest register tile
    (20, 232448, (6, 720, 1280), (32, 64)),  # winsize 41, generic, still fits 48 KB
    (50, 232448, (6, 720, 1280), (32, 64)),  # winsize 101: opt-in above 48 KB
    (50, 60000, (6, 720, 1280), (4, 32)),    # a small card: the largest tile that fits
])
def test_choose_tile(r, limit, shape, tile):
    th, tw, smem = k2.choose_tile(r, limit, *shape)
    assert (th, tw) == tile
    assert smem == k2.smem_bytes(th, tw, r) <= limit
    # the kernel's per-thread register budget: 8 outputs a thread in the
    # generic kernel, a run of up to 14 columns in the register-blocked one
    assert th * tw <= 256 * (14 if r in k2.REG_RADII else 8)


@pytest.mark.parametrize("r,shape,tile", [
    (7, (1, 480, 640), (32, 112)),   # the stream's levels: 90 blocks, one per SM
    (6, (1, 480, 640), (32, 112)),
    (7, (1, 240, 320), (32, 32)),    # 80 blocks of 46 columns, not 160 of 30 on 28 SMs twice
    (7, (1, 120, 160), (32, 16)),
    (7, (1, 60, 80), (32, 16)),
    (7, (8, 480, 640), (32, 112)),   # many waves: the least halo
    (20, (1, 480, 640), (32, 64)),   # the generic kernel's tiles by the same rule
    (20, (1, 60, 80), (2, 32)),
])
def test_choose_tile_balances_the_sms(r, shape, tile):
    """The tile whose busiest SM reads the fewest values: ceil(blocks /
    132) tiles with their halo, the larger tile on a tie."""
    th, tw, _ = k2.choose_tile(r, 232448, *shape)
    assert (th, tw) == tile
    B, H, W = shape

    def busiest(t):
        return -(-B * -(-H // t[0]) * -(-W // t[1]) // 132) * (t[0] + 2 * r) * (t[1] + 2 * r)

    tiles = k2.REG_TILES if r in k2.REG_RADII else k2.TILES
    fits = [t for t in tiles if k2.smem_bytes(*t, r) <= 48 * 1024]
    assert busiest((th, tw)) == min(busiest(t) for t in fits)


def test_register_tiles_fit_without_opt_in():
    """The register-blocked kernel's two vertical-pass buffers are static
    shared memory, under the 48 KB a block gets without opt-in, with an odd
    row stride (32 lanes on 32 rows hit 32 banks); each tile's vertical
    pass has one item per thread at most, in runs of 16 rows or fewer."""
    for r in k2.REG_RADII:
        for th, tw in k2.REG_TILES:
            assert th == 32 and tw % 8 == 0
            assert k2.smem_bytes(th, tw, r) <= 48 * 1024
            assert (k2.smem_bytes(th, tw, r) // (4 * 2 * th)) % 2 == 1
            assert 2 * (tw + 2 * r) <= 256


@pytest.mark.parametrize("winsize,want", [(15, "r7"), (14, "r7"), (13, "r6"),
                                          (1, "generic"), (9, "generic"),
                                          (41, "generic"), (101, "generic")])
def test_blur_solve_variant_by_radius(winsize, want):
    """Radius 7 (winsize 15, cv2's default) and 6 (13, the runtime's default)
    run the register-blocked kernel; every other radius the generic one."""
    assert k2.variant(winsize // 2) == want


def test_choose_tile_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        k2.choose_tile(200, 232448, 1, 480, 640)


def test_blur_solve_wrapper_checks(rng):
    M = torch.from_numpy(_normal_eq(rng, 1, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        k2.blur_solve(M.double(), 5)
    with pytest.raises(ValueError, match="B, 5, H, W"):
        k2.blur_solve(M[:, :4], 5)
    with pytest.raises(ValueError, match="odd"):
        k2.blur_solve(M, 14)  # the box blur of an even window changes sizes
    before = k2.blur_solve.launches
    k2.blur_solve(M, 5)
    assert k2.blur_solve.launches == before


# ---------------------------------------------------------------- K5

def _level_args(H, W, k, pyr=0.5):
    """Level k's size and Gaussian taps, as ``_level_planes`` makes them."""
    return tfb._level_size(H, W, pyr**k), tfb._level_taps(k, pyr)


def test_prep_wrapper_rejects_what_the_kernel_does_not_take(rng):
    img = torch.from_numpy(rng.uniform(0, 255, (2, 40, 48)).astype(np.float32))
    size, blur = _level_args(40, 48, 1)
    with pytest.raises(TypeError, match="float32"):
        k5.farneback_prep(img.double(), size, blur, 5, 1.1)
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        k5.farneback_prep(img[0], size, blur, 5, 1.1)
    with pytest.raises(ValueError, match="contiguous"):
        k5.farneback_prep(img.transpose(1, 2), size, blur, 5, 1.1)
    with pytest.raises(ValueError, match="downscale"):
        k5.farneback_prep(img, (41, 48), blur, 5, 1.1)
    with pytest.raises(ValueError, match="odd"):
        k5.farneback_prep(img, size, blur[:-1], 5, 1.1)


def test_prep_cpu_path_counts_no_launch(rng):
    """On the CPU the wrapper runs the plain version, the very operations of
    ``_level_planes``, and counts no launch."""
    img = torch.from_numpy(rng.uniform(0, 255, (2, 40, 48)).astype(np.float32))
    before = k5.farneback_prep.launches
    for k in (0, 1):
        size, blur = _level_args(40, 48, k)
        got = k5.farneback_prep(img, size, blur, 5, 1.1)
        assert torch.equal(got, tfb._level_planes(img, 40, 48, k, 0.5, 5, 1.1))
    assert k5.farneback_prep.launches == before


@pytest.mark.parametrize("H,W", [(2, 2), (45, 70), (481, 641), (720, 1280), (1080, 1920),
                                 (97, 330), (33, 2000)])
@pytest.mark.parametrize("pyr", [0.5, 0.63, 0.8])
def test_prep_spans_bound_what_a_tile_reads(H, W, pyr):
    """The shared memory the wrapper sizes holds what each tile's blur reads:
    for every tile, the padded rows (columns) from the first slot's to the
    last slot's plus the blur's 2p + 1 taps, through the resize's real tap
    tables, never exceed ``span``; and a strip holds an even number of row
    slots."""
    dev = torch.device("cpu")
    for k in range(tfb._num_levels(H, W, 5, pyr) + 1):
        (lh, lw), blur = _level_args(H, W, k, pyr)
        p = len(blur) // 2
        for n in (*k5.UNROLLED_POLY_N, 1, k5.MAX_POLY_N):
            for tile in k5.TILES:
                cfg = k5.launch_config(H, W, lh, lw, p, n, tile)
                assert cfg["strip_rows"] % 2 == 0 and cfg["strip_rows"] >= 2
                for src, dst, key in ((H, lh, "span_h"), (W, lw, "span_w")):
                    e = np.arange(tile + 2 * n)
                    lo, hi, _ = (t.numpy() for t in _taps(src, dst, dev))
                    for t0 in range(0, dst, tile):
                        lv = np.clip(t0 - n + e, 0, dst - 1)
                        first, last = (lv[0], lv[-1]) if src == dst else (lo[lv[0]], hi[lv[-1]])
                        assert last - first + 2 * p + 1 <= cfg[key], (k, n, tile, key)


@pytest.mark.parametrize("frames,size,p,tile", [
    (7, (720, 1280), 1, 32),    # the 720p clip's finest level: 6,440 blocks
    (7, (180, 320), 4, 32),     # its k = 2: 420 blocks, a 9-tap blur
    (7, (90, 160), 9, 16),      # its k = 3: the 19-tap blur
    (14, (135, 240), 9, 16),    # the 1080p clip's coarsest: 560 blocks, wide blur
    (1, (480, 640), 1, 32),     # a stream frame's finest level: 300 blocks
    (1, (240, 320), 1, 16),     # its k = 1: 80 blocks
    (2, (540, 960), 1, 32),     # the 2x1080p batch's k = 1: 1,020 blocks
    (2, (120, 160), 1, 16),     # a small pair's level: 40 blocks
])
def test_prep_choose_tile(frames, size, p, tile):
    """16 for a wide blur (p >= 5) or a grid of 32-tiles under two blocks
    an SM, else 32 (the rule fitted to the H100's times of both tiles)."""
    assert k5.choose_tile(frames, *size, p) == tile


def test_prep_smem_fits_without_the_card_limit_at_cv2_settings():
    """At cv2's settings (pyr_scale 0.5, poly_n 5 and 7) every level of
    frames up to 4K needs under 64 KB a block: several blocks an SM."""
    for H, W in ((480, 640), (720, 1280), (1080, 1920), (2160, 3840)):
        for k in range(tfb._num_levels(H, W, 3, 0.5) + 1):
            (lh, lw), blur = _level_args(H, W, k)
            for n in k5.UNROLLED_POLY_N:
                for tile in k5.TILES:
                    cfg = k5.launch_config(H, W, lh, lw, len(blur) // 2, n, tile)
                    assert cfg["smem"] < 64 * 1024, (H, W, k, n, tile, cfg)


@pytest.mark.parametrize("pyr", [0.5, 0.8])
def test_prep_smem_fits_the_card_up_to_the_largest_poly_n(pyr):
    """Every poly_n the kernel takes, up to ``MAX_POLY_N``, fits a block of
    either tile in under 100 KB at every level of frames up to 4K, well
    inside the H100's 227 KB: the wrapper's only refusal on the card is
    the cap itself."""
    for H, W in ((480, 640), (720, 1280), (1080, 1920), (2160, 3840)):
        for k in range(tfb._num_levels(H, W, 5, pyr) + 1):
            (lh, lw), blur = _level_args(H, W, k, pyr)
            for n in range(1, k5.MAX_POLY_N + 1):
                for tile in k5.TILES:
                    cfg = k5.launch_config(H, W, lh, lw, len(blur) // 2, n, tile)
                    assert cfg["smem"] < 100 * 1024, (H, W, k, n, tile, cfg)


@pytest.mark.parametrize("poly_n", [1, 3, 9])
def test_prep_cpu_path_takes_any_poly_n(poly_n, rng):
    """The plain version, which the CPU runs, is the same operations for
    any poly_n: ``_level_planes`` through the wrapper equals them and
    counts no launch."""
    img = torch.from_numpy(rng.uniform(0, 255, (2, 40, 48)).astype(np.float32))
    before = k5.farneback_prep.launches
    size, blur = _level_args(40, 48, 1)
    want = k5.farneback_prep_plain(img, size, blur, poly_n, 0.3 * poly_n + 0.5)
    got = tfb._level_planes(img, 40, 48, 1, 0.5, poly_n, 0.3 * poly_n + 0.5)
    assert torch.equal(got, want)
    assert k5.farneback_prep.launches == before
