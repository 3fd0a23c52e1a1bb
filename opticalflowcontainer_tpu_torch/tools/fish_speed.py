"""Object speed from a still pair (the port's copy of the reference's
``tools/fish_speed.py``): the flow of two PNG frames, the mean displacement
over the whole image and over a region of interest, the ROI's speed in m/s
from ``--pixel-to-meter`` and ``--dt``, and, with ``--out-prefix``, the two
frames with the ROI (green) and the ROI moved by its mean flow (red) drawn
on them and the HSV flow image, as PNGs.

    python -m opticalflowcontainer_tpu_torch.tools.fish_speed a.png b.png \\
        [--roi X Y W H] [--out-prefix out/fs] [--cpu]
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("one")
    ap.add_argument("two")
    ap.add_argument("--roi", type=int, nargs=4, metavar=("X", "Y", "W", "H"),
                    default=None, help="region of interest (default: the "
                                       "centre third)")
    ap.add_argument("--pixel-to-meter", type=float, default=0.000566)
    ap.add_argument("--dt", type=float, default=1.0 / 30.0)
    ap.add_argument("--model", default="farneback")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out-prefix", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.png import imread
    from .run_pair import estimate_pair

    img1, img2 = imread(args.one), imread(args.two)
    H, W = img1.shape[:2]
    if args.roi is None:
        args.roi = [W // 3, H // 3, W // 3, H // 3]
    x, y, w, h = args.roi
    if not (w > 0 and h > 0 and 0 <= x and 0 <= y
            and x + w <= W and y + h <= H):
        raise SystemExit(
            f"--roi {x} {y} {w} {h} is not inside the {W}x{H} image "
            "(a clamped slice would report the speed of another region, or "
            "NaN for an empty one)")

    flow = estimate_pair(img1, img2, args.model, args.ckpt, args.cpu)
    full_mu = flow.reshape(-1, 2).mean(axis=0)
    roi_mu = flow[y:y + h, x:x + w].reshape(-1, 2).mean(axis=0)
    vx = roi_mu[0] / args.dt * args.pixel_to_meter
    vy = roi_mu[1] / args.dt * args.pixel_to_meter
    print(f"full-image mean displacement: ({full_mu[0]:+.2f}, {full_mu[1]:+.2f}) px")
    print(f"ROI mean displacement:        ({roi_mu[0]:+.2f}, {roi_mu[1]:+.2f}) px")
    print(f"ROI speed: vx={vx:+.4f} m/s  vy={vy:+.4f} m/s "
          f"(dt={args.dt}s, p2m={args.pixel_to_meter})")

    if args.out_prefix:
        from ..core.draw import rectangle
        from ..runtime.viz import flow_to_bgr
        from ..utils.png import imwrite

        a, b = img1.copy(), img2.copy()
        rectangle(a, (x, y), (x + w, y + h), (0, 255, 0), 2)
        sx, sy = int(round(roi_mu[0])), int(round(roi_mu[1]))
        rectangle(b, (x, y), (x + w, y + h), (0, 255, 0), 2)
        rectangle(b, (x + sx, y + sy), (x + w + sx, y + h + sy), (0, 0, 255), 2)
        imwrite(args.out_prefix + "_one.png", a)
        imwrite(args.out_prefix + "_two.png", b)
        imwrite(args.out_prefix + "_flow.png", flow_to_bgr(flow))
        print("wrote", args.out_prefix + "_{one,two,flow}.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
