"""Seconds from the process's start until the first timed call: imports,
loading (or, in a fresh checkout, building) the kernel libraries, the
model, and the warm-up call at the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
