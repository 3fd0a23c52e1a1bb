"""Side-by-side comparison GIF maker (the port's copy of the reference's
``tools/comparison.py``): two images become a 2-frame looping GIF.

    python -m opticalflowcontainer_tpu_torch.tools.comparison one.png two.jpg \\
        --out comparison.gif --duration-ms 500

The inputs are PNG or JPEG files, read by the port's decoders
(``utils.imcodec``; ``--force-python`` runs their plain forms, for a
machine without nvcc).  The second image is resized to the first's size
with PIL's BICUBIC resample (``core.resize.resize_bicubic_pil``), both
share one median-cut 256-colour palette, and ``utils.gif`` writes the GIF
(loop 0, ``--duration-ms`` a frame).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("one")
    ap.add_argument("two")
    ap.add_argument("--out", default="comparison.gif")
    ap.add_argument("--duration-ms", type=int, default=500)
    ap.add_argument("--force-python", action="store_true",
                    help="decode the inputs with the plain decoders instead "
                         "of the compiled ones (no nvcc needed)")
    args = ap.parse_args(argv)

    from ..core.resize import resize_bicubic_pil
    from ..utils.gif import quantize, write_gif
    from ..utils.imcodec import imread

    frames = []
    for path in (args.one, args.two):
        bgr = imread(path, force_python=args.force_python)
        if bgr is None:
            raise SystemExit(f"cannot read image {path}")
        frames.append(bgr[..., ::-1])
    a, b = frames
    if b.shape[:2] != a.shape[:2]:
        b = resize_bicubic_pil(b, a.shape[:2])
    palette, indexed = quantize([a, b])
    write_gif(args.out, palette, indexed, duration_ms=args.duration_ms, loop=0)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
