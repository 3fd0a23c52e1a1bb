"""PWC-Net's whole step: its operations per pair (counts/pwcnet.py) times
the pairs completed in the untraced window, over its length times the
fp32 peak, in %."""


def read(ctx):
    if ctx.peak is None or ctx.host.fields == 0:
        return None
    return 100.0 * ctx.counts["flops"] * ctx.host.fields / (
        ctx.host.window_s * ctx.peak["fp32_flop_per_s"])
