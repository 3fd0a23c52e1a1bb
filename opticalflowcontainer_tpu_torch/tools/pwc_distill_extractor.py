"""Stage A of the PWC-Net bootstrap: distill the trained LiteFlowNet3 trunk
into PWC-Net's extractor (the port's copy of the reference's
``tools/pwc_distill_extractor.py``, same flags and defaults).

PWC-Net's extractor plus a 1x1 adapter a level (to the trunk's channels,
dropped afterwards) learns to reproduce the packaged LFN3 trunk's features
at the five resolutions both have: PWC-Net level k (1/2^k) against the
trunk's level k + 1, k = 1..5, by the mean squared error over the mean
square of the target, averaged over the levels.  The student sees the raw
[0, 1] frames, the trunk LFN3's per-image mean-removed ones.  The
extractor's parameters are written as the flat npz that
``train_flow --model pwcnet --init-extractor`` grafts before stage B.

    python -m opticalflowcontainer_tpu_torch.tools.pwc_distill_extractor \\
        --steps 3000 [--out pwc_extractor.npz] [--cpu]

``--out`` defaults to ``pwc_extractor.npz`` in the temporary directory
(the reference's ``/tmp/pwc_extractor.npz``).  The teacher is the packaged
``liteflownet3_synth.npz``; without it the tool exits.  The optimizer is the reference's: clip 1.0, AdamW with
optax's default decay 1e-4, a warm-up cosine schedule to 0.02 ``--lr``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
from torch import nn

from ..models import convert
from ..models.common import Conv, flax_init
from ..models.pwcnet import Extractor
from ..parallel.train import AdamW, warmup_cosine_decay
from .train_flow import make_affine_batch

# the LFN3 trunk's channels at its levels 2..6, PWC-Net's levels 1..5
TRUNK_CH = (32, 64, 96, 128, 192)
PWC_CH = (16, 32, 64, 96, 128)


class Student(nn.Module):
    """PWC-Net's extractor and a 1x1 adapter a level to the trunk's
    channels (the reference's flax ``Dense`` on the channels; not
    exported).  PWC-Net's level 6 has no trunk counterpart and keeps its
    init."""

    def __init__(self):
        super().__init__()
        self.extractor = Extractor()
        for k, (cin, ch) in enumerate(zip(PWC_CH, TRUNK_CH)):
            self.add_module(f"adapt{k + 1}", Conv(cin, ch, kernel=1, padding=0))

    def forward(self, img):
        feats = self.extractor(img)
        return [getattr(self, f"adapt{k + 1}")(feats[k]) for k in range(5)]


def feature_loss(outs, targets) -> torch.Tensor:
    """The mean over the batch of each sample's mean over the levels of
    mean((o - t)^2) / (mean(t^2) + 1e-6)."""
    total = 0.0
    for o, t in zip(outs, targets):
        total = total + ((o - t) ** 2).mean((1, 2, 3)) / (
            (t ** 2).mean((1, 2, 3)) + 1e-6)
    return (total / len(outs)).mean()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=2000)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "pwc_extractor.npz"))
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.batch < 1:
        raise SystemExit("--steps and --batch must be positive")
    from ..core.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    teacher = convert.load_liteflownet3_synth(device)
    if teacher is None:
        raise SystemExit("packaged liteflownet3_synth.npz not found: the "
                         "distillation teacher is the packaged LFN3 trunk")
    trunk = teacher.features.requires_grad_(False)

    student = flax_init(Student(), torch.Generator().manual_seed(args.seed))
    student.to(device).train()
    rng = np.random.default_rng(args.seed)
    sched = warmup_cosine_decay(0.0, args.lr, min(200, args.steps // 10 + 1),
                                args.steps, args.lr * 0.02)
    opt = AdamW(dict(student.named_parameters()), sched, 1e-4)

    t0 = time.time()
    for it in range(1, args.steps + 1):
        batch = make_affine_batch(rng, args.batch, args.height, args.width,
                                  mesh_prob=0.3, color_prob=0.5)
        imgs = np.concatenate([batch["img1"][:args.batch // 2],
                               batch["img2"][:(args.batch + 1) // 2]])
        x = torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2)
        with torch.no_grad():
            targets = trunk(x - x.mean((2, 3), keepdim=True))[1:6]
        loss = feature_loss(student(x), targets)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if it % args.log_every == 0 or it == 1:
            print(f"step {it:5d}  feat-loss {float(loss.detach()):7.4f}  "
                  f"{it / max(time.time() - t0, 1e-9):.2f} steps/s", flush=True)
    convert.save_flat_npz(student.extractor, args.out)
    print(f"done: extractor -> {args.out} (final feat-loss {float(loss.detach()):.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
