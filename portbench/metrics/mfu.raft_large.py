"""RAFT (large)'s whole step: its operations per pair (counts/raft_large.py:
the encoders, the all-pairs product, ``iters`` updates' convolutions and
the mask head) times the pairs completed in the untraced window, over its
length times the fp32 peak, in %."""


def read(ctx):
    if ctx.peak is None or ctx.host.fields == 0:
        return None
    return 100.0 * ctx.counts["flops"] * ctx.host.fields / (
        ctx.host.window_s * ctx.peak["fp32_flop_per_s"])
