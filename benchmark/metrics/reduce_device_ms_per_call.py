"""Device milliseconds a call of the reduce over replicas: the device time
of the work launched under the program's ``hs.reduce`` ranges, over the
traced calls (the host time under the range holds the reduce's wait for
the kernel, so it is not read)."""


def read(ctx):
    us = ctx.trace.device_us_under("hs.reduce")
    return us / 1e3 / len(ctx.trace.calls) if us > 0 else None
