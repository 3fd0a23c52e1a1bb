"""The port's kernels as the trace names them, and the shares that the
metric readers compute from them."""
from __future__ import annotations

import re

from .counts import least_seconds

K1 = ("farneback_update_kernel",)
K2 = ("blur_solve_kernel", "blur_solve_reg_kernel")
K3 = ("warp_bilinear_kernel",)
K4 = ("correlation_kernel", "correlation_reduce_kernel")
# cuDNN's and cuBLAS's convolution kernels (implicit GEMM, FFT, the
# transposed convolutions' dgrad, GEMV at the smallest levels) and the
# layout transforms cuDNN runs around them
CONV = re.compile(r"conv|gemm|gemv|xmma|fprop|dgrad|winograd|fft|cudnn|cutlass|"
                  r"nchwtonhwc|nhwctonchw|implicit", re.IGNORECASE)


def named(names):
    """Matcher of a kernel whose (demangled) name holds one of ``names`` as
    its function name."""
    pat = re.compile(r"(^|[\s:])(" + "|".join(map(re.escape, names)) + r")\b")
    return lambda n: bool(pat.search(n))


def is_conv(name: str) -> bool:
    return bool(CONV.search(name))


def roofline(ctx, key: str, match) -> float | None:
    """Share (%) of the least time of ``ctx.counts[key]`` (per field) over
    the device time of the kernels ``match`` accepts, or None where the
    configuration has no such entry, the card no peak, or the trace no
    such kernel."""
    work = ctx.counts.get(key)
    seconds = ctx.trace.kernel_seconds(match)
    if work is None or ctx.peak is None or seconds <= 0 or ctx.fields == 0:
        return None
    return 100.0 * least_seconds(work["flops"], work["bytes"], ctx.peak) \
        * ctx.fields / seconds


def ms_per_field(ctx, match) -> float | None:
    seconds = ctx.trace.kernel_seconds(match)
    if seconds <= 0 or ctx.fields == 0:
        return None
    return 1e3 * seconds / ctx.fields
