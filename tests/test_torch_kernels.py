"""The port's two Farneback kernels, K1 ``farneback_update`` and K2
``blur_solve``, held against the JAX package on the CPU.

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


@pytest.mark.parametrize("r,limit,tile", [
    (7, 232448, (32, 64)),     # winsize 15: largest tile, no opt-in
    (20, 232448, (32, 64)),    # winsize 41 still fits 48 KB
    (50, 232448, (32, 64)),    # winsize 101: opt-in above 48 KB
    (50, 60000, (4, 32)),      # a small card: the largest tile that fits
])
def test_choose_tile(r, limit, tile):
    th, tw, smem = k2.choose_tile(r, limit)
    assert (th, tw) == tile
    assert smem == k2.smem_bytes(th, tw, r) <= limit
    assert th * tw <= 256 * 8  # the kernel's per-thread register budget


def test_choose_tile_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        k2.choose_tile(200, 232448)


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
