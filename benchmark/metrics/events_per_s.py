"""Simulated events a second: the events of every call completed in the
window over the window's wall time, from the first call's start to the
last call's end, on the host clock."""


def read(ctx):
    return sum(c["events"] for c in ctx.calls) / ctx.window_s
