"""Frame capture utility (the port's copy of the reference's
``tools/record.py``): read N frames from a video file and write them as an
AVI and/or numbered PNGs.

    python -m opticalflowcontainer_tpu_torch.tools.record in.avi --frames 150 \\
        --out-avi out.avi --out-dir frames/

The source is a Motion-JPEG or uncompressed AVI, read by
``runtime.sources.VideoFileSource`` (its JPEG decoder compiled unless
``--force-python``).  ``--out-dir`` gets ``frame_00000.png``, ... written by
``utils.png.imwrite``.  ``--out-avi`` gets an uncompressed 24-bit AVI
(``utils.avi.AviWriter``) where the reference writes XVID, which needs an
MPEG-4 encoder the port does not have.  A camera index (the reference's
``cv2.VideoCapture(0)``) needs V4L2 and is refused.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("source", help="video file path (a camera index is "
                                   "refused: it needs V4L2)")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--out-avi", default=None,
                    help="write an uncompressed 24-bit AVI (the reference "
                         "writes XVID, which needs an MPEG-4 encoder)")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--fps", type=float, default=None,
                    help="output AVI fps (default: the source's fps when it "
                         "reports one, else 30)")
    ap.add_argument("--force-python", action="store_true",
                    help="decode with the plain JPEG decoder instead of the "
                         "compiled one (no nvcc needed)")
    args = ap.parse_args(argv)

    import os

    from ..runtime.sources import VideoFileSource
    from ..utils.avi import AviWriter
    from ..utils.png import imwrite

    if args.source.isdigit():
        raise SystemExit(
            f"camera index {args.source}: live capture needs V4L2, which the "
            "port does not read; record from a video file")
    if not os.path.isfile(args.source):
        raise SystemExit(f"cannot open source {args.source}")
    src = VideoFileSource(args.source, force_python=args.force_python)
    if args.fps is None:
        # write at the source's native rate or playback speed changes
        args.fps = src.file_fps or 30.0
    writer = None
    n = 0
    try:
        for frame in src.frames():
            if n >= args.frames:
                break
            if args.out_avi:
                if writer is None:
                    writer = AviWriter(args.out_avi, args.fps,
                                       (frame.shape[1], frame.shape[0]))
                writer.write(frame)
            if args.out_dir:
                os.makedirs(args.out_dir, exist_ok=True)
                imwrite(os.path.join(args.out_dir, f"frame_{n:05d}.png"), frame)
            n += 1
    finally:
        if writer is not None:
            writer.close()
    print(f"captured {n} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
