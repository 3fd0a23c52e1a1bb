"""The card's idle ms per flow field in gaps whose midpoint lies inside the
program's ``ofc.raft.lookup`` spans: the host launching the lookup's
operations faster than the card finishes them, or not."""
from portbench.spans import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "ofc.raft.lookup", ctx.fields)
