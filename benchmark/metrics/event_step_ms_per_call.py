"""Device milliseconds a call of the event-step kernel: the device time of
the work launched under the program's ``hs.kernel`` ranges in the traced
window, over the calls."""


def read(ctx):
    us = ctx.trace.device_us_under("hs.kernel")
    return us / 1e3 / len(ctx.trace.calls) if us > 0 else None
