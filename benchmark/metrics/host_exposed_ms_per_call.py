"""Host milliseconds a call that the device does not cover: each traced
call's wall time less the device-busy time inside it, averaged over the
calls."""


def read(ctx):
    exposed = ctx.trace.host_exposed_us()
    return sum(exposed) / len(exposed) / 1e3
