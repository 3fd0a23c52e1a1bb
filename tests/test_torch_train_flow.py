"""The port's trainer held against the JAX package on the CPU: the optimizer
and its schedule against optax, three ``train_step``s against the
reference's, ``make_affine_batch`` against the reference's generator (and
the reference's two generator tests, with cv2 as the oracle as there), the
exported npz read by the reference's loader and run through its model,
``train_flow.main --cpu`` for every family, the PWC-Net bootstrap
(``pwc_distill_extractor`` then ``--init-extractor --freeze-extractor``),
``--distill``, ``--resume``, and the flag checks made before anything is
built.  Inputs are made with numpy from a seed.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opticalflowcontainer_tpu.models as jmodels
from _torch_train import flat, jax_init, port_model
from opticalflowcontainer_tpu.models.common import load_flat_npz as jload_flat_npz
from opticalflowcontainer_tpu.parallel import train as jptrain
from opticalflowcontainer_tpu.tools import train_flow as jtrain
from opticalflowcontainer_tpu_torch.core import device as tdevice
from opticalflowcontainer_tpu_torch.core.affine import warp_affine_linear
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models.common import flax_init
from opticalflowcontainer_tpu_torch.parallel import train as tptrain
from opticalflowcontainer_tpu_torch.tools import pwc_distill_extractor, train_flow as ttrain
from test_torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "schedule"])
@pytest.mark.parametrize("clip", [False, True], ids=["unclipped", "clipped"])
def test_optimizer_matches_optax(clip, schedule, rng):
    """Ten updates from identical gradients: the port's AdamW equals
    ``optax.chain(clip_by_global_norm(1), adamw(lr, weight_decay=1e-5))``
    within 1e-6 (fp32 rounding of the moments and of the clip factor).
    The gradients' global norm is above 1 on every step (``clipped``) or
    below it on every step.  With the warm-up schedule the first update
    has lr 0 and moves nothing, decay included."""
    shapes = {"conv/kernel": (3, 3, 4, 5), "conv/bias": (5,), "dense/kernel": (6, 7)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    scale = 3.0 if clip else 0.01
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(10)]
    norms = [np.sqrt(sum(float((g ** 2).sum()) for g in step.values())) for step in grads]
    assert all(n > 1 for n in norms) if clip else all(n < 1 for n in norms)
    jsched = (optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10, 2e-4)
              if schedule else 1e-2)
    tsched = (tptrain.warmup_cosine_decay(0.0, 1e-2, 3, 10, 2e-4) if schedule else 1e-2)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(jsched, weight_decay=1e-5))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tptrain.AdamW(tp, tsched, 1e-5, clip=1.0)
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        if schedule and i == 0:
            for k, p in tp.items():
                np.testing.assert_array_equal(p.detach().numpy(), params[k])
    assert opt.count == 10
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("lr,warmup,steps", [(2e-4, 200, 4000), (1e-3, 3, 30),
                                             (2e-4, 1, 2), (1e-3, 201, 3000)])
def test_schedule_matches_optax_at_every_step(lr, warmup, steps):
    """``warmup_cosine_decay`` == ``optax.warmup_cosine_decay_schedule(0,
    lr, warmup, steps, 0.02 lr)`` at every count from 0 past the end,
    within 1e-6 of the peak (both fp32)."""
    want = np.asarray(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, 0.02 * lr)(
        jnp.arange(steps + 3)))
    sched = tptrain.warmup_cosine_decay(0.0, lr, warmup, steps, 0.02 * lr)
    got = np.array([sched(k) for k in range(steps + 3)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * lr)
    assert got[0] == 0.0 and abs(got[-1] - 0.02 * lr) <= 1e-6 * lr


def _shift_batch(rng, B=2, H=32, W=32, max_shift=3):
    """tests/test_training.py's batch: a blurred texture shifted in x."""
    img1 = np.zeros((B, H, W, 3), np.float32)
    img2 = np.zeros((B, H, W, 3), np.float32)
    flow = np.zeros((B, H, W, 2), np.float32)
    for i in range(B):
        base = cv2.GaussianBlur(rng.uniform(0, 1, (H + 16, W + 16)).astype(np.float32),
                                (0, 0), 1.5)
        dx = int(rng.integers(-max_shift, max_shift + 1))
        img1[i] = np.repeat(base[8:8 + H, 8:8 + W, None], 3, -1)
        img2[i] = np.repeat(base[8:8 + H, 8 - dx:8 + W - dx, None], 3, -1)
        flow[i, ..., 0] = dx
    return {"img1": img1, "img2": img2, "flow": flow}


def test_three_train_steps_match_jax(rng):
    """RAFT-small, 32x32, 2 iterations, from the reference's
    ``make_train_state`` params: three ``train_step``s on both sides.

    - The first loss equals the reference's within 1e-5 (same params).
    - After the first update, the params equal the reference's within 1e-6
      where the gradient is above 1e-3 of the model's largest.  Adam's
      first update is lr * g / (|g| + eps), lr times the gradient's sign:
      where |g| is within the two frameworks' rounding of 0 (the biases
      before an InstanceNorm, whose gradient is 0 but for rounding) the
      sign is noise, and such a param moves up to 2 lr apart.
    - The next two losses within 1e-3 of the reference's: they start from
      params that differ by that sign noise (measured ~1e-5)."""
    # make_train_state's params and optimizer, the init jitted
    model, params = jax_init(jmodels.RAFTSmall, 32, 32, 2)
    tx = jptrain.make_optimizer(4e-4)
    jstate = jptrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    jstep = jax.jit(lambda s, b: jptrain.train_step(model, tx, s, b, iters=2))
    tmodel = port_model("raft_small", jstate.params)
    tstate = tptrain.TrainState(tmodel, tptrain.make_optimizer(dict(tmodel.named_parameters())))
    batches = [_shift_batch(rng) for _ in range(3)]
    for i, b in enumerate(batches):
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tloss = tptrain.train_step(tstate, b, iters=2)
        bar = 1e-5 if i == 0 else 1e-3
        assert abs(float(tloss) - float(jloss)) <= bar * abs(float(jloss)), (i, tloss, jloss)
        if i == 0:
            want = convert.flax_to_torch_state_dict(flat(jstate.params), tmodel)
            gmax = max(float(p.grad.abs().max()) for p in tmodel.parameters())
            for n, p in tmodel.named_parameters():
                signed = p.grad.abs() > 1e-3 * gmax
                if signed.any():
                    assert float((p.detach() - want[n]).abs()[signed].max()) <= 1e-6, n
    assert tstate.step == 3 and int(jstate.step) == 3


# ------------------------------------------------------------ batches

@pytest.mark.parametrize("kw", [dict(), dict(mesh_prob=1.0, color_prob=1.0),
                                dict(max_t=4.0, max_angle=2.0, scales=(0.98, 1.02),
                                     mesh_prob=1.0)],
                         ids=["default", "mesh_color", "easy_mesh"])
def test_make_affine_batch_matches_jax(kw):
    """The port's batch == the reference's from the same seed, photometric
    augmentation on: the frames within 4e-6 (the eval pair generators' bar:
    the blur's fp32 rounding), the flow within 1e-5 px, and the generator's
    next draw equal (the same draws in the same order, mesh lines of
    thickness 1 and 2 included)."""
    rj, rt = np.random.default_rng(21), np.random.default_rng(21)
    want = jtrain.make_affine_batch(rj, B=6, H=96, W=128, **kw)
    got = ttrain.make_affine_batch(rt, B=6, H=96, W=128, **kw)
    for k in ("img1", "img2"):
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        assert np.abs(got[k] - want[k]).max() <= 4e-6, k
    assert np.abs(got["flow"] - want["flow"]).max() <= 1e-5
    assert rt.uniform() == rj.uniform()


def test_affine_batch_ground_truth_consistent():
    """tests/test_training.py's check on the port's generator: img2 warped
    back by the ground truth (cv2.remap, the oracle) reproduces img1 in
    the interior."""
    b = ttrain.make_affine_batch(np.random.default_rng(7), B=2, H=48, W=64, max_t=5.0,
                                 max_angle=4.0, photometric=False)
    for i in range(2):
        img1, img2, gt = b["img1"][i, ..., 0], b["img2"][i, ..., 0], b["flow"][i]
        H, W = img1.shape
        xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        back = cv2.remap(img2, xs + gt[..., 0], ys + gt[..., 1], cv2.INTER_LINEAR)
        err = np.abs(back - img1)[8:-8, 8:-8]
        # double bilinear resampling on fine texture costs ~0.01; a sign or
        # axis error ~0.1-0.3
        assert float(err.mean()) < 0.02, err.mean()


def test_affine_batch_pad_covers_extremal_inverse_warp(monkeypatch):
    """tests/test_training.py's check on the port's generator: with the
    warp's border made NaN, an extremal draw (8 degrees, scale 0.92, a
    16 px shift) at 128x192 leaks no border pixel into img2."""

    class ExtremalRng:
        """Forces ang=+8, sc=0.92, t=(+16,+16); other draws stay random."""

        def __init__(self, seed=0):
            self._inner = np.random.default_rng(seed)

        def uniform(self, low=0.0, high=1.0, size=None):
            if (low, high) == (-8.0, 8.0) and size is None:
                return 8.0
            if (low, high) == (0.92, 1.1) and size is None:
                return 0.92
            if (low, high) == (-16.0, 16.0) and size == 2:
                return np.array([16.0, 16.0])
            return self._inner.uniform(low, high, size)

        def normal(self, *a, **k):
            return self._inner.normal(*a, **k)

    def nan_border(img, M, dsize):
        # the canvas inside a NaN ring wider than any displacement: a tap
        # outside the canvas reads NaN, as cv2's borderValue=NaN gives
        P = max(dsize) + 8
        src = np.pad(np.asarray(img, np.float32), P, constant_values=np.nan)
        M2 = np.array(M, np.float64)
        M2[:, 2] = M2[:, 2] - M2[:, :2] @ np.array([P, P], np.float64)
        return warp_affine_linear(src, M2, dsize)

    monkeypatch.setattr(ttrain, "warp_affine_linear", nan_border)
    b = ttrain.make_affine_batch(ExtremalRng(), B=1, H=128, W=192, photometric=False)
    assert int(np.isnan(b["img2"]).sum()) == 0 and int(np.isnan(b["img1"]).sum()) == 0
    # a shift of 2.5 px: the first three columns read a tap outside the
    # image, as does the last row (its lower taps, of weight 0)
    probe = nan_border(np.ones((6, 6), np.float32), np.array([[1, 0, 2.5], [0, 1, 0]]), (6, 6))
    assert np.isnan(probe[:, :3]).all() and np.isnan(probe[-1]).all()
    assert not np.isnan(probe[:-1, 3:]).any()


def test_affine_batch_mesh_and_color_augmentation():
    """tests/test_training.py's check on the port's generator: colourised
    channels differ and stay in [0, 1], and the mesh, drawn before the
    warp, keeps the ground truth exact (cv2.remap as the oracle)."""
    b = ttrain.make_affine_batch(np.random.default_rng(11), B=4, H=64, W=96, max_t=4.0,
                                 max_angle=3.0, photometric=False, mesh_prob=1.0,
                                 color_prob=1.0)
    assert np.abs(b["img1"][..., 0] - b["img1"][..., 1]).mean() > 1e-3
    assert b["img1"].min() >= 0.0 and b["img1"].max() <= 1.0
    for i in range(4):
        img1, img2, gt = b["img1"][i, ..., 0], b["img2"][i, ..., 0], b["flow"][i]
        H, W = img1.shape
        xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        back = cv2.remap(img2, xs + gt[..., 0], ys + gt[..., 1], cv2.INTER_LINEAR)
        assert float(np.abs(back - img1)[8:-8, 8:-8].mean()) < 0.05


# ------------------------------------------------------------ export

@pytest.mark.parametrize("name,cls,H,W", [("pwcnet", jmodels.PWCNet, 64, 64),
                                          ("neuflow_lite", jmodels.NeuFlowLite, 48, 64)])
def test_export_runs_in_the_reference(name, cls, H, W, tmp_path, rng):
    """A port model from the trainer's init, exported as the flat npz, read
    by the reference's ``load_flat_npz`` into its model: its flow equals
    the port's within 1e-4 of the flow's largest entry (fp32 in two
    frameworks; measured ~1e-6)."""
    model = flax_init(ttrain.build_model(name), torch.Generator().manual_seed(7))
    if name in ttrain.PYRAMID_MODELS:
        ttrain._kaiming_rescale(model)
    path = str(tmp_path / f"{name}.npz")
    convert.save_flat_npz(model, path)
    params = jload_flat_npz(path)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.roll(a, (1, 2), (0, 1))
    want = np.asarray(jax.jit(cls().apply)(params, a, b))
    with torch.no_grad():
        got = model(torch.from_numpy(a).permute(2, 0, 1)[None],
                    torch.from_numpy(b).permute(2, 0, 1)[None])[0].permute(1, 2, 0).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_export_refuses_a_parameter_without_a_key_of_its_own():
    class Twice(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(2))
            self.register_parameter("scale", torch.nn.Parameter(torch.zeros(2)))
            self.norm = torch.nn.LayerNorm(2)

    model = Twice()
    # a LayerNorm's weight is flax's "scale": a module parameter of that
    # name at the same path would take the same key
    model.norm.register_parameter("scale", torch.nn.Parameter(torch.zeros(2)))
    with pytest.raises(ValueError, match="taken"):
        convert.torch_to_flax_flat(model)


# ------------------------------------------------------------ the tool

FAMILY_ARGS = {
    "raft_small": ["--height", "32", "--width", "32", "--iters", "2"],
    "raft_large": ["--height", "32", "--width", "32", "--iters", "1"],
    "pwcnet": ["--height", "64", "--width", "64"],
    "liteflownet": ["--height", "32", "--width", "32"],
    "liteflownet3": ["--height", "32", "--width", "32"],
    "neuflow_lite": ["--height", "32", "--width", "32"],
    "neuflow_v2": ["--height", "32", "--width", "32", "--iters", "1"],
}


@pytest.mark.parametrize("name", sorted(FAMILY_ARGS))
def test_train_flow_main_on_the_cpu(name, tmp_path, capsys):
    """``train_flow.main --cpu`` for 3 steps at B=2: a finite loss logged
    every step, a checkpoint at step 2, and the exported npz holding the
    packaged npz's keys and shapes (the reference's parameter tree) and
    loading into the port's model."""
    out = str(tmp_path / f"{name}.npz")
    argv = ["--cpu", "--model", name, "--steps", "3", "--batch", "2", "--log-every", "1",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ckpt"), "--out", out,
            *FAMILY_ARGS[name]]
    assert ttrain.main(argv) == 0
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert [int(ln[1]) for ln in lines] == [1, 2, 3]
    assert all(np.isfinite(float(ln[3])) for ln in lines)
    assert os.listdir(tmp_path / "ckpt") == ["step_00000002"]
    got = convert.load_flat_npz(out)
    packaged = convert.load_flat_npz(convert.WEIGHTS_DIR / f"{name}_synth.npz")
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in packaged.items()}
    model = ttrain.build_model(name)
    model.load_state_dict(convert.flax_to_torch_state_dict(got, model))


def test_pwc_bootstrap_distill_then_frozen_stage_b(tmp_path, capsys):
    """Stage A (``pwc_distill_extractor --cpu``, the packaged LFN3 trunk as
    the teacher) writes PWC-Net's extractor in the npz layout
    ``--init-extractor`` reads; stage B grafts it and, with
    ``--freeze-extractor``, trains the decoders while the extractor stays
    bit for bit what was grafted (no decay drift, as the reference zeroes
    the extractor's updates)."""
    ext = str(tmp_path / "ext.npz")
    assert pwc_distill_extractor.main(["--cpu", "--steps", "2", "--batch", "2", "--height",
                                       "64", "--width", "64", "--log-every", "1",
                                       "--out", ext]) == 0
    assert "feat-loss" in capsys.readouterr().out
    grafted = convert.load_flat_npz(ext)
    packaged = convert.load_flat_npz(convert.WEIGHTS_DIR / "pwcnet_synth.npz")
    assert {f"extractor/{k}": v.shape for k, v in grafted.items()} == {
        k: v.shape for k, v in packaged.items() if k.startswith("extractor/")}
    out = str(tmp_path / "pwc.npz")
    assert ttrain.main(["--cpu", "--model", "pwcnet", "--steps", "2", "--batch", "2",
                        "--height", "64", "--width", "64", "--ckpt-every", "0",
                        "--init-extractor", ext, "--freeze-extractor", "--out", out]) == 0
    assert "grafted distilled extractor" in capsys.readouterr().out
    trained = convert.load_flat_npz(out)
    for k, v in grafted.items():
        np.testing.assert_array_equal(trained[f"extractor/{k}"], v)
    init = flax_init(ttrain.build_model("pwcnet"), torch.Generator().manual_seed(1000))
    start = convert.torch_to_flax_flat(ttrain._kaiming_rescale(init))
    moved = [k for k in start if not k.startswith("extractor/")
             and not np.array_equal(start[k], trained[k])]
    assert len(moved) > 0.9 * sum(not k.startswith("extractor/") for k in start)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **{k: v[..., :1] for k, v in grafted.items()})
    with pytest.raises(SystemExit, match="shape mismatch"):
        ttrain.main(["--cpu", "--model", "pwcnet", "--steps", "2", "--height", "64",
                     "--width", "64", "--init-extractor", bad, "--out", out])


def test_distill_and_resume(tmp_path, capsys):
    """``--distill raft_small`` supervises on the packaged teacher's flow
    (another loss than the ground truth's from the same seed), and
    ``--resume`` starts from the --out npz."""
    out = str(tmp_path / "nf.npz")
    argv = ["--cpu", "--model", "neuflow_lite", "--steps", "2", "--batch", "1",
            "--height", "32", "--width", "32", "--log-every", "1", "--ckpt-every", "0",
            "--out", out]

    def first_loss():
        return float(next(ln.split()[3] for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("step")))

    assert ttrain.main(argv) == 0
    gt_loss = first_loss()
    assert ttrain.main(argv + ["--distill", "raft_small"]) == 0
    assert first_loss() != gt_loss
    assert ttrain.main(argv + ["--resume"]) == 0
    assert "resumed params from" in capsys.readouterr().out


def test_train_flow_flag_validation(monkeypatch):
    """The reference's flag test on the port's tool, which checks every
    flag before it builds the schedule, the device or the model (the
    reference builds its schedule and model first and fails its own test):
    --curriculum with --motion-mix, and --freeze-extractor or
    --init-extractor on a model without an extractor, raise SystemExit;
    so do sizes the model cannot take and a run too short for the
    warm-up."""
    def built(*a, **k):
        raise AssertionError("built before the flags were checked")

    for mod, attr in ((ttrain, "warmup_cosine_decay"), (ttrain, "build_model"),
                      (tdevice, "resolve_device")):
        monkeypatch.setattr(mod, attr, built)
    with pytest.raises(SystemExit, match="mutually"):
        ttrain.main(["--model", "pwcnet", "--curriculum", "--motion-mix", "--steps", "1",
                     "--cpu"])
    with pytest.raises(SystemExit, match="extractor"):
        ttrain.main(["--model", "raft_small", "--freeze-extractor", "--steps", "1",
                     "--batch", "1", "--height", "32", "--width", "32", "--cpu",
                     "--out", "never_written.npz"])
    with pytest.raises(SystemExit, match="pwcnet stage-B"):
        ttrain.main(["--model", "liteflownet", "--init-extractor", "x.npz", "--cpu"])
    with pytest.raises(SystemExit, match="multiples of 64"):
        ttrain.main(["--model", "pwcnet", "--cpu"])
    with pytest.raises(SystemExit, match="warm-up"):
        ttrain.main(["--model", "raft_small", "--steps", "1", "--cpu"])


def test_train_flow_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--model", "raft_small", "--steps", "2"])


@pytest.mark.parametrize("name", sorted(FAMILY_ARGS))
def test_training_after_serving_in_one_process(name):
    """A family served under ``torch.inference_mode()`` then trained at the
    same size in the same process: the cached constant tensors (resize
    taps, RAFT's lookup tables, NeuFlow-v2's position embedding) are built
    outside inference mode, so the training step can save them for
    backward."""
    size = 64 if name == "pwcnet" else 32
    model = flax_init(ttrain.build_model(name), torch.Generator().manual_seed(0))
    b = tptrain.batch_to_device(ttrain.make_affine_batch(
        np.random.default_rng(0), 1, size, size), "cpu")
    with torch.inference_mode():
        model(b["img1"], b["img2"])
    state = tptrain.TrainState(model, tptrain.make_optimizer(dict(model.named_parameters())))
    tptrain.descend(state, ttrain.make_loss(name, iters=1)(model, b))
    assert state.step == 1
