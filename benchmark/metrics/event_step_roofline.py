"""The event-step kernel's share of its roofline: the least time the
traced calls' event steps could take (``benchmark/roofline.py``, the
larger of the bytes' and the integer operations' times) over the device
time of the work launched under ``hs.kernel``, in percent."""

from benchmark import roofline


def read(ctx):
    us = ctx.trace.device_us_under("hs.kernel")
    if us <= 0:
        return None
    least = sum(roofline.least_seconds(ctx.spec, c["totals"])[0] for c in ctx.traced_calls)
    return 100.0 * least / (us / 1e6)
