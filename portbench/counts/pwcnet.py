"""PWC-Net's operations and bytes per pair at the net's input size (the
frames resized up to multiples of 64).

- ``flops``: every convolution, 2 * Cin * Cout * k^2 * Ho * Wo, and every
  transposed convolution, 2 * Cin * Cout * k^2 * Hi * Wi (each input pixel
  meets the whole kernel), as ``torch.utils.flop_counter`` counts them,
  plus the 81-channel correlation of each level, 2 * C * 81 * H * W.  The
  extractor runs on both frames.  Activations, concatenations, warps and
  resizes are not counted.
- ``k3``: the four masked warps (levels 5..2): the source features and
  u, v read once, the warped features written once, fp32; 8 operations a
  channel and pixel (four taps, a multiply and an add each).
- ``k4``: the five correlations (levels 6..2): both feature maps read
  once, the 81 planes written once, fp32.
"""
from __future__ import annotations

EXTRACTOR = (16, 32, 64, 96, 128, 196)
DENSE = (128, 128, 96, 64, 32)
REFINER = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
CORR = 81
F32 = 4


def padded(n: int) -> int:
    return -(-n // 64) * 64


def decoder_in(level: int) -> int:
    return CORR if level == 6 else CORR + EXTRACTOR[level - 1] + 4


def layers(H: int, W: int) -> list[tuple]:
    """(kind, cin, cout, k, h, w) of every convolution of one pair: h, w is
    the output size of a convolution, the input size of a transposed one."""
    Hp, Wp = padded(H), padded(W)
    out = []
    cin = 3
    for lv, ch in enumerate(EXTRACTOR, 1):
        h, w = Hp >> lv, Wp >> lv
        for i in range(3):  # both frames
            out += [("conv", cin if i == 0 else ch, ch, 3, h, w)] * 2
        cin = ch
    for lv in (6, 5, 4, 3, 2):
        h, w = Hp >> lv, Wp >> lv
        if lv < 6:
            out.append(("deconv", 2, 2, 4, h // 2, w // 2))
            out.append(("deconv", decoder_in(lv + 1) + sum(DENSE), 2, 4,
                        h // 2, w // 2))
        c = decoder_in(lv)
        for ch in DENSE:
            out.append(("conv", c, ch, 3, h, w))
            c += ch
        out.append(("conv", c, 2, 3, h, w))
    h, w = Hp >> 2, Wp >> 2
    c = decoder_in(2) + sum(DENSE)
    for ch, _ in REFINER:
        out.append(("conv", c, ch, 3, h, w))
        c = ch
    out.append(("conv", c, 2, 3, h, w))
    return out


def conv_flops(H: int, W: int) -> int:
    return sum(2 * ci * co * k * k * h * w for _, ci, co, k, h, w in layers(H, W))


def counts(config: dict, traffic: dict) -> dict:
    H, W = traffic["height"], traffic["width"]
    Hp, Wp = padded(H), padded(W)
    corr_flops = 0
    k3 = {"flops": 0, "bytes": 0}
    k4 = {"flops": 0, "bytes": 0}
    for lv in (6, 5, 4, 3, 2):
        C, h, w = EXTRACTOR[lv - 1], Hp >> lv, Wp >> lv
        corr_flops += 2 * C * CORR * h * w
        k4["flops"] += 2 * C * CORR * h * w
        k4["bytes"] += F32 * (2 * C + CORR) * h * w
        if lv < 6:
            k3["flops"] += 8 * C * h * w
            k3["bytes"] += F32 * (2 * C + 2) * h * w
    return {"flops": conv_flops(H, W) + corr_flops, "k3": k3, "k4": k4}
