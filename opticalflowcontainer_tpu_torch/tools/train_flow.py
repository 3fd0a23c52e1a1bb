"""Train a flow model of the zoo on synthetic affine motion and export its
weights (the port's copy of the reference's ``tools/train_flow.py``, same
flags and defaults).

Batches are exact-ground-truth affine warps of procedural textures (the
family the eval harness scores on, covering its easy and hard ranges, with
photometric augmentation, an optional fishnet mesh and colour), made on
the host from ``--seed`` by the port's copies of cv2 (``core/affine.py``,
``core/draw.py``) in the reference's order of random draws.  Each family
trains on the reference's loss:

- ``raft_small`` / ``raft_large``: the sequence loss over ``--iters``
  flows (``parallel/train.py``);
- ``pwcnet`` / ``liteflownet`` / ``liteflownet3``: per-level L1 against
  the ground truth area-downsampled to each level, in the net's /20 units,
  weighted {6: .32, 5: .08, 4: .02, 3: .01, 2: .005}; their norm-free
  trunks start from the flax init times 1.55 (:func:`_kaiming_rescale`);
- ``neuflow_lite`` / ``neuflow_v2``: L1 of the flow plus 0.3 times L1 of
  the matching stage's flow (``return_aux``); v2 refines ``--iters`` times
  at 1/8.

The optimizer is the reference's: global-norm clip 1.0, AdamW (decay
1e-5) on a warm-up cosine schedule to 0.02 ``--lr``.  On the card the
PWC-Net, LiteFlowNet, LFN3 and NeuFlow steps run K3 and K4 forward; their
backward is the plain versions' autograd.

    python -m opticalflowcontainer_tpu_torch.tools.train_flow \\
        --model raft_small --steps 6000 [--cpu]

Checkpoints (``parallel/checkpoint.py``) land under ``--ckpt-dir`` every
``--ckpt-every`` steps beside the exported flat npz (``--out``, by default
the packaged ``<model>_synth.npz`` that both packages' loaders read).  It
runs on the card unless ``--cpu`` is given, and raises when there is no
card.  Every flag is checked before the schedule or the model is built.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from ..core.affine import gaussian_blur, rotation_matrix_2d, warp_affine_linear
from ..core.draw import line
from ..core.resize import resize_area
from ..eval.datasets import affine_warp_pad
from ..models import (RAFT, LiteFlowNet, LiteFlowNet3, NeuFlowLite, NeuFlowV2,
                      PWCNet, RAFTSmall, convert)
from ..models.common import flax_init, fp32_convolutions
from ..parallel.checkpoint import save_checkpoint
from ..parallel.train import (TrainState, batch_to_device, descend,
                              make_optimizer, sequence_loss,
                              warmup_cosine_decay)

FAMILIES = {"raft_small": RAFTSmall, "raft_large": RAFT,
            "neuflow_lite": NeuFlowLite, "neuflow_v2": NeuFlowV2,
            "pwcnet": PWCNet, "liteflownet3": LiteFlowNet3,
            "liteflownet": LiteFlowNet}
# the coarse-to-fine families' per-level loss weights (PWC-Net's schedule)
LEVEL_WEIGHTS = {6: 0.32, 5: 0.08, 4: 0.02, 3: 0.01, 2: 0.005}
PYRAMID_MODELS = ("pwcnet", "liteflownet3", "liteflownet")
# the families that serve fp32 convolutions train with them, backward too
FP32_MODELS = ("raft_small", "raft_large", "neuflow_lite", "neuflow_v2", "pwcnet")
# what --height and --width must be multiples of: each net's coarsest level
# must halve evenly into the next (PWC-Net's 2x deconvolutions meet its
# extractor's levels only at multiples of 64; the reference fails there at
# run time, e.g. at the default 96 x 128, and trained PWC-Net at 128 x 192)
SIZE_MULTIPLE = {"raft_small": 8, "raft_large": 8, "neuflow_lite": 16,
                 "neuflow_v2": 16, "pwcnet": 64, "liteflownet3": 32,
                 "liteflownet": 32}


def _draw_mesh(rng, base: np.ndarray) -> None:
    """Overlay a procedural net on ``base`` in place: two families of
    jittered parallel polylines (random spacing, angle, polarity and
    thickness), the deployment domain's thin periodic strands.  The
    reference draws them with ``cv2.polylines(..., LINE_AA)`` on a float32
    image, where cv2 draws the 8-connected line; :func:`~..core.draw.line`
    draws each segment as cv2 does."""
    h, w = base.shape
    spacing = rng.uniform(10, 48)
    ang = rng.uniform(0, np.pi)
    thick = int(rng.integers(1, 3))
    # line intensity: darker or brighter than the background
    val = float(rng.uniform(0.0, 0.25) if rng.uniform() < 0.5
                else rng.uniform(0.75, 1.0))
    jitter = rng.uniform(0, 0.25) * spacing
    diag = int(np.hypot(h, w)) + 1
    for fam in range(2):
        a = ang + np.pi / 2 * fam + rng.uniform(-0.06, 0.06)
        dx, dy = np.cos(a), np.sin(a)
        nx, ny = -dy, dx  # line normal
        n_lines = int(diag / spacing) + 2
        for k in range(-n_lines, n_lines):
            # a polyline with sinusoidal jitter: strands are not ideal lines
            ts = np.linspace(-diag, diag, 16)
            off = k * spacing + jitter * np.sin(
                ts / rng.uniform(20, 80) + rng.uniform(0, 6.28))
            xs = w / 2 + dx * ts + nx * off
            ys = h / 2 + dy * ts + ny * off
            pts = np.stack([xs, ys], -1).astype(np.int32)
            for p, q in zip(pts[:-1], pts[1:]):
                line(base, p, q, val, thick)


def make_affine_batch(rng, B=8, H=96, W=128, max_t=16.0, max_angle=8.0,
                      scales=(0.92, 1.1), textures=3, photometric=True,
                      mesh_prob=0.0, color_prob=0.0) -> dict:
    """Exact-ground-truth affine frame pairs on a multi-scale procedural
    texture, drawn from the numpy generator ``rng`` in the reference's
    order: dict(img1, img2 [B, H, W, 3] float32 in [0, 1], flow
    [B, H, W, 2]).

    Rotation (``max_angle`` degrees), scale (``scales``) and translation
    (``max_t`` px) about the image centre; ``photometric`` gives half the
    samples a gain and offset on frame 2 and sensor noise on both;
    ``mesh_prob`` overlays a fishnet mesh (:func:`_draw_mesh`) before the
    warp, so the ground truth stays exact; ``color_prob`` colours both
    frames with one random per-channel gain and offset instead of
    replicating the gray image."""
    pad = affine_warp_pad(H, W, max_t, max_angle, scales)
    img1 = np.zeros((B, H, W, 3), np.float32)
    img2 = np.zeros((B, H, W, 3), np.float32)
    flow = np.zeros((B, H, W, 2), np.float32)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32) + pad,
                         np.arange(H, dtype=np.float32) + pad)
    for i in range(B):
        base = np.zeros((H + 2 * pad, W + 2 * pad), np.float32)
        for s in range(textures):
            sigma = 0.8 + 1.2 * s + rng.uniform(0, 0.8)
            base += gaussian_blur(
                rng.uniform(0, 1, base.shape).astype(np.float32), sigma
            ) * rng.uniform(0.4, 1.0)
        base -= base.min()
        base /= max(base.max(), 1e-6)
        if rng.uniform() < mesh_prob:
            _draw_mesh(rng, base)
        ang = rng.uniform(-max_angle, max_angle)
        sc = rng.uniform(*scales)
        tx, ty = rng.uniform(-max_t, max_t, 2)
        M = rotation_matrix_2d((W / 2 + pad, H / 2 + pad), ang, sc)
        M[:, 2] += (tx, ty)
        f1 = base[pad:pad + H, pad:pad + W]
        f2 = warp_affine_linear(base, M, base.shape[::-1])[pad:pad + H,
                                                           pad:pad + W]
        if photometric and rng.uniform() < 0.5:
            f2 = np.clip(f2 * rng.uniform(0.6, 1.4) + rng.uniform(-0.1, 0.1), 0, 1)
            f1 = np.clip(f1 + rng.normal(0, 0.016, f1.shape), 0, 1).astype(np.float32)
            f2 = np.clip(f2 + rng.normal(0, 0.016, f2.shape), 0, 1).astype(np.float32)
        if rng.uniform() < color_prob:
            # one per-channel gain and offset on both frames: the luminance
            # stays the warped signal, the channels differ
            g = rng.uniform(0.3, 1.0, 3).astype(np.float32)
            o = rng.uniform(0.0, 0.5, 3).astype(np.float32) * (1.0 - g)
            img1[i] = np.clip(f1[..., None] * g + o, 0, 1)
            img2[i] = np.clip(f2[..., None] * g + o, 0, 1)
        else:
            img1[i] = f1[..., None]
            img2[i] = f2[..., None]
        # forward flow(p1) = M p1 - p1
        x2 = M[0, 0] * xs + M[0, 1] * ys + M[0, 2]
        y2 = M[1, 0] * xs + M[1, 1] * ys + M[1, 2]
        flow[i, ..., 0] = x2 - xs
        flow[i, ..., 1] = y2 - ys
    return {"img1": img1, "img2": img2, "flow": flow}


@torch.no_grad()
def _kaiming_rescale(model: torch.nn.Module, gain: float = 1.55) -> torch.nn.Module:
    """Multiply every convolution (and linear) weight by ``gain``, at init
    only: the flax init decays the activations of a norm-free leaky-conv
    trunk ~0.7x a conv, and PWC-Net's 18-conv extractor collapses by
    level 6; 1.55 keeps the level stds flat (the reference's measurement).
    In place; returns ``model``."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                          torch.nn.Linear)):
            m.weight.mul_(gain)
    return model


def build_model(name: str) -> torch.nn.Module:
    """The untrained family ``name`` at full width, on the CPU."""
    return FAMILIES[name]()


def pyramid_loss(pyramid: dict, gt: torch.Tensor) -> torch.Tensor:
    """Sum over the levels of ``LEVEL_WEIGHTS[l]`` times the mean |flow_l -
    gt_l|, gt_l the ground truth [B, 2, H, W] area-downsampled to level l's
    size in the net's /20 units."""
    B, _, H, W = gt.shape
    hwc = gt.permute(2, 3, 0, 1).reshape(H, W, 2 * B)
    total = 0.0
    for lvl, fl in pyramid.items():
        h, w = fl.shape[-2:]
        gt_l = resize_area(hwc, (h, w)).reshape(h, w, B, 2).permute(2, 3, 0, 1)
        total = total + LEVEL_WEIGHTS[lvl] * (fl - gt_l * (1.0 / 20.0)).abs().mean()
    return total


def make_loss(name: str, iters: int = 8):
    """``loss(model, b)`` of family ``name`` on a device batch ``b``
    (:func:`~..parallel.train.batch_to_device`): the mean over the batch of
    the reference's per-sample training loss."""
    if name in ("raft_small", "raft_large"):
        return lambda model, b: sequence_loss(
            model(b["img1"], b["img2"], iters), b["flow"])
    if name in PYRAMID_MODELS:
        def loss(model, b):
            _, pyramid = model(b["img1"], b["img2"], return_pyramid=True)
            return pyramid_loss(pyramid, b["flow"])
        return loss
    kwargs = {"iters_s8": iters} if name == "neuflow_v2" else {}

    def aux_loss(model, b):
        # the final flow and the matching stage's, so that the matching
        # learns instead of hiding behind the refiner
        out, aux = model(b["img1"], b["img2"], return_aux=True, **kwargs)
        return (out - b["flow"]).abs().mean() + 0.3 * (aux - b["flow"]).abs().mean()
    return aux_loss


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags and defaults, each checked here, before
    anything is built."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="raft_small", choices=tuple(FAMILIES))
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8,
                    help="refinement iterations (RAFT GRU iters; "
                         "NeuFlow-v2 s8 refinement iters)")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--out", default=None,
                    help="npz path (default: packaged <model>_synth.npz)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="initialize from the existing --out npz")
    ap.add_argument("--curriculum", action="store_true",
                    help="ramp motion magnitude from tiny to full over the "
                         "first 60%% of steps")
    ap.add_argument("--distill", default=None,
                    choices=("raft_large", "raft_small"),
                    help="supervise on the packaged teacher's predicted flow "
                         "(12 iterations, the last flow) instead of the "
                         "ground truth")
    ap.add_argument("--init-extractor", default=None, metavar="NPZ",
                    help="pwcnet only: graft a feature-distilled extractor "
                         "(tools/pwc_distill_extractor.py) over the fresh "
                         "init before training")
    ap.add_argument("--freeze-extractor", action="store_true",
                    help="pwcnet only: train the decoders and the refiner, "
                         "not the extractor")
    ap.add_argument("--motion-mix", action="store_true",
                    help="interleave easy/hard motion regimes per batch "
                         "(even steps: <=4 px, 2 deg, 2%% zoom)")
    ap.add_argument("--mesh-prob", type=float, default=0.0,
                    help="probability of overlaying a procedural fishnet "
                         "mesh on each training texture")
    ap.add_argument("--color-prob", type=float, default=0.0,
                    help="probability of per-channel colorization instead "
                         "of gray-replicated 3-channel frames")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.curriculum and args.motion_mix:
        # the per-step branch would pick the curriculum every step
        raise SystemExit("--curriculum and --motion-mix are mutually "
                         "exclusive (the curriculum branch would win every "
                         "step and the mix would never fire)")
    if args.freeze_extractor and args.model != "pwcnet":
        raise SystemExit(f"--freeze-extractor: model {args.model!r} has no "
                         "'extractor' param group (pwcnet stage-B option)")
    if args.init_extractor and args.model != "pwcnet":
        raise SystemExit("--init-extractor is a pwcnet stage-B option")
    mult = SIZE_MULTIPLE[args.model]
    if args.height % mult or args.width % mult:
        raise SystemExit(f"--model {args.model} takes --height and --width "
                         f"multiples of {mult}, got {args.height} x {args.width}")
    if args.steps < 1 or args.batch < 1 or args.iters < 1:
        raise SystemExit("--steps, --batch and --iters must be positive")
    if args.steps <= min(args.warmup, max(args.steps // 10, 1)):
        raise SystemExit(f"--steps {args.steps} leaves no step after the "
                         "warm-up for the cosine decay")
    return args


def _motion(args, step: int) -> dict:
    """make_affine_batch's motion range at ``step``."""
    if args.curriculum:
        f = min(step / max(args.steps * 0.6, 1.0), 1.0)
        return dict(max_t=2.0 + 14.0 * f, max_angle=1.0 + 7.0 * f,
                    scales=(1.0 - 0.08 * f, 1.0 + 0.1 * f))
    if args.motion_mix and step % 2 == 0:
        # even steps: the eval's easy regime (<= 4 px, +-2 deg, +-2% zoom)
        return dict(max_t=4.0, max_angle=2.0, scales=(0.98, 1.02))
    return {}


def _graft_extractor(model, path: str) -> None:
    """Load the extractor npz at ``path`` into PWC-Net's extractor, after
    checking its keys and shapes against the extractor's."""
    got_flat = convert.load_flat_npz(path)
    got = {k: v.shape for k, v in got_flat.items()}
    want = {k: v.shape for k, v in convert.torch_to_flax_flat(model.extractor).items()}
    if got != want:
        raise SystemExit(f"--init-extractor shape mismatch: {got} != {want}")
    model.extractor.load_state_dict(
        convert.flax_to_torch_state_dict(got_flat, model.extractor))


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..core.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    name = args.model
    out = args.out or os.path.join(convert.WEIGHTS_DIR, f"{name}_synth.npz")
    if not out.endswith(".npz"):
        # np.savez appends .npz to a bare path, which would break --resume
        out += ".npz"
    ckpt_dir = args.ckpt_dir or f"checkpoints/{name}_synth"
    rng = np.random.default_rng(args.seed)
    warmup = min(args.warmup, max(args.steps // 10, 1))
    sched = warmup_cosine_decay(0.0, args.lr, warmup, args.steps, args.lr * 0.02)

    model = build_model(name)
    if args.resume and os.path.exists(out):
        # the --out npz itself, which may differ from the packaged path
        model.load_state_dict(convert.flax_to_torch_state_dict(
            convert.load_flat_npz(out), model))
        print(f"resumed params from {out}")
    else:
        flax_init(model, torch.Generator().manual_seed(args.seed))
        if name in PYRAMID_MODELS:
            # norm-free leaky-conv trunks: keep the activations from decaying
            _kaiming_rescale(model)
    if args.init_extractor:
        _graft_extractor(model, args.init_extractor)
        print(f"grafted distilled extractor from {args.init_extractor}")
    model.to(device).train()
    params = {k: p for k, p in model.named_parameters()
              if not (args.freeze_extractor and k.startswith("extractor."))}
    for k, p in model.named_parameters():
        p.requires_grad_(k in params)
    state = TrainState(model, make_optimizer(params, sched))
    loss_fn = make_loss(name, args.iters)
    precision = fp32_convolutions if name in FP32_MODELS else contextlib.nullcontext

    teacher = None
    if args.distill:
        load = (convert.load_raft_synth if args.distill == "raft_large"
                else convert.load_raft_small_synth)
        teacher = load(device)
        if teacher is None:
            raise SystemExit(f"--distill {args.distill}: packaged teacher "
                             f"weights not found under {convert.WEIGHTS_DIR}")
        print(f"distilling from {args.distill} teacher")

    t0 = time.time()
    losses = []
    for step in range(1, args.steps + 1):
        batch = batch_to_device(make_affine_batch(
            rng, args.batch, args.height, args.width, mesh_prob=args.mesh_prob,
            color_prob=args.color_prob, **_motion(args, step)), device)
        if teacher is not None:
            with torch.no_grad():
                batch["flow"] = teacher(batch["img1"], batch["img2"], 12,
                                        final_only=True)
        with precision():
            loss = loss_fn(model, batch)
            descend(state, loss)
        if step % args.log_every == 0 or step == 1:
            value = float(loss.detach())  # sync
            losses.append(value)
            rate = step / max(time.time() - t0, 1e-9)
            print(f"step {step:5d}  loss {value:8.4f}  lr {sched(step):.2e}  "
                  f"{rate:.2f} steps/s", flush=True)
        if args.ckpt_every and step % args.ckpt_every == 0:
            save_checkpoint(ckpt_dir, state, step)
            convert.save_flat_npz(model, out)
            print(f"checkpoint @ {step} -> {ckpt_dir}; npz -> {out}", flush=True)
    convert.save_flat_npz(model, out)
    print(f"done: {args.steps} steps in {time.time() - t0:.0f}s; "
          f"final loss {losses[-1]:.4f}; weights -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
