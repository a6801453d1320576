"""Models with several sources or sinks, or nodes no source reaches,
built with the same code in both packages (``mod`` is either package's
model module), at the sizes the CPU tests run.

This module holds no test and imports neither package, so the CPU
parity tests (test_torch_multisource.py, test_torch_multisource_runs.py)
and the card's tests (test_torch_gpu.py, run where JAX is not installed)
share it."""

# Models, built with the same code in both packages (``mod`` is either
# package's model module).
def superpose(mod, horizon_s=20.0, kind="poisson", rates=(5.0, 3.0)):
    """Two sources superposed on one server (mu = 10, queue 512) -> one
    sink: at 5/s and 3/s Poisson, the M/M/1 at lambda = 8; two constant
    sources at one rate fire at exactly the same times (the tie case)."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=horizon_s / 4)
    srv = m.server(service_mean=0.1, queue_capacity=512)
    for rate in rates:
        m.connect(m.source(rate=rate, kind=kind), srv)
    m.connect(srv, m.sink())
    return m


def two_class(mod, horizon_s=20.0, window_s=None, n_front=4, loss_p=0.0, deadline_s=None):
    """A two-tenant service: source 0 (Poisson 7.5/s a front server) ->
    least_outstanding over the n_front front servers (mu = 10, queue 256)
    -> sink 0; source 1 (a constant 4/s batch job) over a 5 ms constant
    edge -> the next server (mu = 8, queue 64) -> sink 1; the last
    server, wired to sink 1, fed by nothing. With four front servers:
    30/s over servers 0-3, the batch job on server 4, server 5 spare.
    With chaos, the batch edge loses ``loss_p`` of its crossings and the
    batch server times a job out after ``deadline_s`` and retries it once
    at its queue's tail (the front servers never retry)."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=horizon_s / 4)
    web = m.source(rate=7.5 * n_front)
    batch = m.source(rate=4.0, kind="constant")
    lb = m.router(policy="least_outstanding")
    front = [m.server(service_mean=0.1, queue_capacity=256) for _ in range(n_front)]
    retry = dict(deadline_s=deadline_s, max_retries=1) if deadline_s is not None else {}
    back = m.server(service_mean=0.125, queue_capacity=64, **retry)
    spare = m.server(service_mean=0.125, queue_capacity=64)
    web_sink, batch_sink = m.sink(), m.sink()
    m.connect(web, lb)
    for server in front:
        m.connect(lb, server)
        m.connect(server, web_sink)
    m.connect(batch, back, latency_s=0.005, loss_p=loss_p)
    m.connect(back, batch_sink)
    m.connect(spare, batch_sink)
    if window_s is not None:
        m.telemetry(window_s=window_s)
    return m


def two_class_defended(mod, horizon_s=4.0):
    """two-class-chaos (two front servers) with a retry budget of 0.2
    tokens a second, bursts of one, which suppresses most of the batch
    server's retries."""
    m = two_class(mod, horizon_s=horizon_s, n_front=2, loss_p=0.05, deadline_s=0.25)
    m.retry_budget(ratio=0.0, min_per_s=0.2, burst=1.0)
    return m


def superpose_faulted(mod, horizon_s=4.0):
    """Two Poisson sources (5/s and 3/s) superposed on one server (mean
    0.1 s, queue 64) -> one sink, the server dark in a pinned outage over
    [1, 1.8) s: each rejection retries after a 0.1 s backoff with jitter
    0.5 while its two retries last (parked in the transit registers),
    else it is a fault drop; a start whose service outlasts 0.15 s
    launches a hedge."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=horizon_s / 8, transit_capacity=16)
    srv = m.server(
        service_mean=0.1, queue_capacity=64, max_retries=2, retry_backoff_s=0.1,
        retry_jitter=0.5, hedge_delay_s=0.15,
        fault=mod.FaultSpec(windows=((1.0, 1.8),), mode="outage"),
    )
    for rate in (5.0, 3.0):
        m.connect(m.source(rate=rate), srv)
    m.connect(srv, m.sink())
    return m


def profiled(mod, horizon_s=20.0):
    """Three sources into one 2-slot server: a flat Poisson 6/s, a ramp
    2 -> 12/s over half the horizon and a constant-kind spike 10/s over a
    base of 1/s (two rows of profile tables)."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    srv = m.server(service_mean=0.05, queue_capacity=64, concurrency=2)
    m.connect(m.source(rate=6.0), srv)
    m.connect(m.ramp_source(2.0, 12.0, horizon_s / 2), srv)
    m.connect(m.spike_source(1.0, 10.0, horizon_s / 4, horizon_s / 2, kind="constant"), srv)
    m.connect(srv, m.sink())
    return m


def orphan_router(mod, horizon_s=10.0):
    """The M/M/1 with a router no source reaches."""
    m = mod.mm1_model(8.0, 10.0, horizon_s)
    m.router(targets=[mod.NodeRef(mod.SERVER, 0)])
    return m


def orphan_limiter(mod, horizon_s=10.0):
    """The M/M/1 with a limiter no source reaches."""
    m = mod.mm1_model(8.0, 10.0, horizon_s)
    limiter = m.limiter(refill_rate=1.0, capacity=1.0)
    m.connect(limiter, mod.NodeRef(mod.SERVER, 0))
    return m


def no_sink(mod, horizon_s=5.0):
    """A server feeding itself back through a router: no path reaches
    the sink (tests/test_torch_engine.py's decline model)."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    server = m.server()
    router = m.router(targets=[server])
    m.connect(m.source(rate=1.0), router)
    m.connect(server, router)
    m.sink()
    return m


MULTI_MODELS = {
    "superpose": superpose,
    "superpose-tie": lambda mod: superpose(mod, kind="constant", rates=(4.0, 4.0)),
    "two-class": lambda mod: two_class(mod, horizon_s=4.0, n_front=2),
    "two-class-telemetry": lambda mod: two_class(mod, horizon_s=4.0, window_s=0.5, n_front=2),
    "profiled": profiled,
    # Several sources or sinks with chaos: losses, timeouts and tail
    # retries at the batch server; fault rejections, backoff retries,
    # fault drops and hedges at a superposed server.
    "two-class-chaos": lambda mod: two_class(
        mod, horizon_s=4.0, n_front=2, loss_p=0.05, deadline_s=0.25
    ),
    "superpose-faulted": superpose_faulted,
    # The same with a defense: the whole chaos code with every site.
    "two-class-defended": lambda mod: two_class_defended(mod),
    "orphan-router": orphan_router,
    "orphan-limiter": orphan_limiter,
    "no-sink": no_sink,
}
