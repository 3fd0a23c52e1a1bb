"""The card's idle ms per frame in gaps whose midpoint lies inside the
program's ``ofc.model.forward`` spans."""
from portbench.spans import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "ofc.model.forward", ctx.calls)
