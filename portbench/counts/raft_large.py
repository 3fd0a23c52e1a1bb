"""RAFT (large)'s operations and bytes per pair at the net's input size (the
frames resized up to multiples of 8), from its published widths.

- ``flops``: every convolution, 2 * Cin * Cout * kh * kw * Ho * Wo, as
  ``torch.utils.flop_counter`` counts them, and the all-pairs product,
  2 * C * N^2 for N = (H/8) * (W/8) positions; apart as ``encoders`` (the
  feature encoder on both frames, the context encoder on the first),
  ``volume`` (the product), ``updates`` (``iters`` times the motion
  encoder, the SepConvGRU and the flow head) and ``upsample`` (the mask
  head, once).  Norms, activations, the pyramid's pooling, the lookup and
  the convex combination are not counted.
- ``lookup``: the least work of the ``iters`` windowed lookups, fp32: for
  each position and each of the 324 samples (4 levels of 9 x 9) its four
  taps read once and the sample written once; 8 operations a sample (four
  taps, a multiply and an add each).
"""
from __future__ import annotations

STEM = (3, 64, 7)
STAGES = ((64, 1), (96, 2), (128, 2))
FEATURES = 256
HIDDEN = CONTEXT = 128
LEVELS, RADIUS = 4, 4
CORR = LEVELS * (2 * RADIUS + 1) ** 2
F32 = 4


def padded(n: int) -> int:
    return -(-n // 8) * 8


def encoder_layers(H: int, W: int) -> list[tuple]:
    """(cin, cout, kh, kw, ho, wo) of one encoder pass over one frame."""
    cin, cout, k = STEM
    h, w = H // 2, W // 2
    out = [(cin, cout, k, k, h, w)]
    cin = cout
    for ch, stride in STAGES:
        h, w = h // stride, w // stride
        out.append((cin, ch, 3, 3, h, w))
        out.append((ch, ch, 3, 3, h, w))
        if stride != 1 or cin != ch:
            out.append((cin, ch, 1, 1, h, w))
        out += [(ch, ch, 3, 3, h, w)] * 2
        cin = ch
    out.append((cin, FEATURES, 1, 1, h, w))
    return out


def update_layers(h: int, w: int) -> list[tuple]:
    """(cin, cout, kh, kw, h, w) of one update at 1/8."""
    gru_in = HIDDEN + CONTEXT + 128
    return ([(CORR, 256, 1, 1, h, w), (256, 192, 3, 3, h, w),
             (2, 128, 7, 7, h, w), (128, 64, 3, 3, h, w),
             (192 + 64, 126, 3, 3, h, w)]
            + [(gru_in, HIDDEN, kh, kw, h, w)
               for kh, kw in ((1, 5), (5, 1)) for _ in range(3)]
            + [(HIDDEN, 256, 3, 3, h, w), (256, 2, 3, 3, h, w)])


def conv_flops(layers) -> int:
    return sum(2 * ci * co * kh * kw * h * w for ci, co, kh, kw, h, w in layers)


def counts(config: dict, traffic: dict) -> dict:
    H, W = padded(traffic["height"]), padded(traffic["width"])
    h, w = H // 8, W // 8
    n = h * w
    iters = config["iters"]
    parts = {
        "encoders": 3 * conv_flops(encoder_layers(H, W)),
        "volume": 2 * FEATURES * n * n,
        "updates": iters * conv_flops(update_layers(h, w)),
        "upsample": conv_flops([(HIDDEN, 256, 3, 3, h, w), (256, 576, 1, 1, h, w)]),
    }
    lookup = {"flops": iters * n * CORR * 8,
              "bytes": iters * n * CORR * 5 * F32}
    return {"flops": sum(parts.values()), **parts, "lookup": lookup}
