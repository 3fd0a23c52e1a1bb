"""Farneback's operations and bytes per flow field of a clip call (T frames
of S cameras, (T - 1) * S fields), at the configuration's settings.

- ``k1`` (the update, every level and iteration): 68 bytes a pixel, R0's
  and R1's five planes, u and v read, M's five written (fp32); 80
  operations a pixel (the bilinear sample of five planes, the averaged
  normal equations, the border ramp).
- ``k2`` (blur and solve): 28 bytes a pixel, M read, u and v written;
  the winsize box on five planes in two passes, 20 * winsize operations a
  pixel, and 13 for the 2x2 solve.
- ``prep`` (blur, resize and expansion of every frame, once per level in
  a clip): the uint8 frame read once per level, the level's five fp32
  planes written once; operations: the separable Gaussian at full
  resolution (4 * ksize a pixel), the bilinear resize (6 a level pixel),
  the expansion (three vertical and six horizontal passes of 2 * poly_n +
  1 taps, 2 operations a tap, and 10 for the five planes).
- ``flops`` and ``bytes`` of the whole step: the operations above at
  cv2's stage boundaries plus the flow's resize between levels (6 a level
  pixel for u and v each); the bytes the least any implementation moves,
  the uint8 frames in and the fp32 flow out.
"""
from __future__ import annotations

F32 = 4


def _levels(H: int, W: int, levels: int, pyr_scale: float):
    """(k, lh, lw, blur ksize) of each level, cv2's clamp on the depth."""
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if W * scale < 32.0 or H * scale < 32.0:
            break
        k += 1
    out = []
    for i in range(k, -1, -1):
        s = pyr_scale ** i
        ks = max(int(round((1.0 / s - 1.0) * 0.5 * 5)) | 1, 3)
        out.append((i, int(round(H * s)), int(round(W * s)), ks))
    return out


def counts(config: dict, traffic: dict) -> dict:
    p = config["params"]
    H, W = traffic["height"], traffic["width"]
    T, S = traffic["frames_per_call"], traffic.get("streams", 1)
    fields = (T - 1) * S
    taps = 2 * p["poly_n"] + 1
    k1 = {"flops": 0.0, "bytes": 0.0}
    k2 = {"flops": 0.0, "bytes": 0.0}
    prep = {"flops": 0.0, "bytes": 0.0}
    resize = 0.0
    levels = _levels(H, W, p["levels"], p["pyr_scale"])
    for k, lh, lw, ks in levels:
        n = lh * lw
        k1["flops"] += p["iterations"] * 80 * n * fields
        k1["bytes"] += p["iterations"] * 68 * n * fields
        k2["flops"] += p["iterations"] * (20 * p["winsize"] + 13) * n * fields
        k2["bytes"] += p["iterations"] * 28 * n * fields
        prep["flops"] += T * S * (4 * ks * H * W + (6 * n if k else 0)
                                  + (9 * taps * 2 + 10) * n)
        prep["bytes"] += T * S * (H * W + 5 * F32 * n)
        if k != levels[0][0]:
            resize += 2 * 6 * n * fields
    per_field = lambda d: {key: v / fields for key, v in d.items()}
    return {"flops": (k1["flops"] + k2["flops"] + prep["flops"] + resize) / fields,
            "bytes": (T * S * H * W + fields * H * W * 2 * F32) / fields,
            "k1": per_field(k1), "k2": per_field(k2), "prep": per_field(prep)}
