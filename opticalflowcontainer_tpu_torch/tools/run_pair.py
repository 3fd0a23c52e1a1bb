"""Two-image flow CLI: the flow between two PNG stills, written as a ``.flo``
file and/or an HSV PNG (the port's copy of the reference's
``tools/run_pair.py``).

    python -m opticalflowcontainer_tpu_torch.tools.run_pair a.png b.png \\
        --out-flo f.flo --out-png f.png [--model pwcnet] [--cpu]

Every method of the eval harness (farneback, the default, needs no
weights), built by ``eval.run_eval._make_method``, so the two CLIs serve
the same weights: the packaged npz, ``--ckpt cand.npz`` or a reference
torch checkpoint ``--ckpt x.pytorch``.  On the card unless ``--cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np


def estimate_pair(img1, img2, model_name: str = "farneback", ckpt: str | None = None,
                  on_cpu: bool = False) -> np.ndarray:
    """Flow [H, W, 2] float32 from two BGR uint8 images (``imread``'s
    layout)."""
    from ..eval.run_eval import _make_method

    run = _make_method(model_name, ckpt, quick=False,
                       device="cpu" if on_cpu else None)
    # the eval methods take RGB floats in [0, 1]
    i1 = np.ascontiguousarray(img1[..., 2::-1]).astype(np.float32) / 255.0
    i2 = np.ascontiguousarray(img2[..., 2::-1]).astype(np.float32) / 255.0
    return np.asarray(run(i1, i2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("one")
    ap.add_argument("two")
    ap.add_argument("--model", default="farneback")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out-flo", default=None)
    ap.add_argument("--out-png", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.png import imread

    img1, img2 = imread(args.one), imread(args.two)
    flow = estimate_pair(img1, img2, args.model, args.ckpt, args.cpu)
    print(f"flow: shape={flow.shape} mean u={flow[..., 0].mean():+.3f} "
          f"mean v={flow[..., 1].mean():+.3f} max |f|={np.abs(flow).max():.3f}")
    if args.out_flo:
        from ..utils.flo import write_flo

        write_flo(args.out_flo, flow)
        print("wrote", args.out_flo)
    if args.out_png:
        from ..runtime.viz import flow_to_bgr
        from ..utils.png import imwrite

        imwrite(args.out_png, flow_to_bgr(flow))
        print("wrote", args.out_png)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
