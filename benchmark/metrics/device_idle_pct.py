"""The share of the traced window in which no kernel, copy or memset runs
on the device, in percent."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (t.window_us - t.busy_us) / t.window_us
