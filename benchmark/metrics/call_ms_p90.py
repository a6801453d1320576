"""The 90th percentile of the calls' wall times in milliseconds: each call
from its entry until its result is back on the host and the device is
synchronised (``statistics.quantiles``, inclusive method)."""

import statistics


def read(ctx):
    walls = [c["wall_s"] * 1e3 for c in ctx.calls]
    if len(walls) < 2:
        return walls[0]
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
