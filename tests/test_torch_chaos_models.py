"""Chaos models built with the same code in both packages (``mod`` is
either package's model module): deadlines, retries, hedges, brownouts,
fault schedules and packet loss, at the sizes the CPU tests run.

This module holds no test and imports neither package, so the CPU
parity tests (test_torch_chaos.py) and the card's tests
(test_torch_gpu.py, run where JAX is not installed) share it."""


def deadline_mm1(mod, horizon_s=20.0):
    """λ=9.5, μ=10, deadline 0.8 s with 2 immediate retries, a 16-slot
    queue: expiries, tail re-enqueues pulled back in the same step, and
    retries that find the queue full."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=5.0)
    src = m.source(rate=9.5)
    srv = m.server(service_mean=0.1, queue_capacity=16, deadline_s=0.8, max_retries=2)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


def backoff_chain(mod, horizon_s=20.0):
    """Two servers, each with deadline 0.3 s, 3 retries after a 0.05 s
    backoff with jitter 0.5: retries park in the transit registers of a
    line of free edges."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=2.0, transit_capacity=8)
    src = m.source(rate=8.0)
    kw = dict(queue_capacity=32, deadline_s=0.3, max_retries=3, retry_backoff_s=0.05, retry_jitter=0.5)
    a = m.server(service_mean=0.08, **kw)
    b = m.server(service_mean=0.06, **kw)
    m.connect(src, a)
    m.connect(a, b)
    m.connect(b, m.sink())
    return m


def hedged(mod, service="exponential", horizon_s=20.0, **shape):
    """The hedged M/M/1 of test_tpu_faults.py (λ=4, mean 0.1, hedge
    0.2 s), or the same server with another service family."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=5.0)
    src = m.source(rate=4.0)
    srv = m.server(service_mean=0.1, service=service, queue_capacity=64, hedge_delay_s=0.2, **shape)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


def brownout(mod, horizon_s=20.0):
    """An M/M/1 browned out over [5, 8)."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=8.0)
    srv = m.server(service_mean=0.1, queue_capacity=64, outage=(5.0, 8.0))
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


def pinned(mod, horizon_s=20.0):
    """An outage-mode server with pinned windows and a brownout that
    overlaps its first window (an arrival in both is only a brownout
    drop), then a 2-slot server degraded to 1 slot and 3x service in its
    pinned windows."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=1.0)
    src = m.source(rate=8.0)
    a = m.server(
        service_mean=0.05, queue_capacity=64, outage=(4.0, 6.0),
        fault=mod.FaultSpec(windows=((3.0, 5.0), (9.0, 11.0)), mode="outage"),
    )
    b = m.server(
        concurrency=2, service_mean=0.15, queue_capacity=64,
        fault=mod.FaultSpec(
            windows=((2.0, 6.0), (12.0, 15.0)), mode="degrade",
            capacity_factor=0.5, latency_factor=3.0,
        ),
    )
    m.connect(src, a)
    m.connect(a, b)
    m.connect(b, m.sink())
    return m


def stochastic(mod, horizon_s=20.0):
    """Stochastic outage windows with fault retries (backoff 0.05 s,
    jitter 0.25, 2 retries, 4 transit registers) before a server with
    constant-duration degrade windows."""
    m = mod.EnsembleModel(horizon_s=horizon_s, transit_capacity=4)
    src = m.source(rate=8.0)
    a = m.server(
        service_mean=0.05, queue_capacity=64, max_retries=2,
        retry_backoff_s=0.05, retry_jitter=0.25,
        fault=mod.FaultSpec(rate=0.3, mean_duration_s=0.5, max_windows=24),
    )
    b = m.server(
        concurrency=2, service_mean=0.08, queue_capacity=64,
        fault=mod.FaultSpec(
            rate=0.5, mean_duration_s=1.0, duration="constant", mode="degrade",
            capacity_factor=0.5, latency_factor=2.0, max_windows=16,
        ),
    )
    m.connect(src, a)
    m.connect(a, b)
    m.connect(b, m.sink())
    return m


def correlated(mod, horizon_s=20.0):
    """Correlated outages (and each server's own windows) on a 2-server
    round-robin; only server 0 retries."""
    m = mod.EnsembleModel(horizon_s=horizon_s, transit_capacity=8)
    m.correlated_outages(rate=0.2, mean_duration_s=1.0, trigger_p=0.5, max_windows=8)
    src = m.source(rate=10.0)
    a = m.server(
        service_mean=0.08, queue_capacity=64, max_retries=1, retry_backoff_s=0.1,
        fault=mod.FaultSpec(rate=0.1, mean_duration_s=0.5, correlated=True, max_windows=8),
    )
    b = m.server(service_mean=0.08, queue_capacity=64, fault=mod.FaultSpec(correlated=True))
    router = m.router(policy="round_robin")
    snk = m.sink()
    m.connect(src, router)
    m.connect(router, a)
    m.connect(router, b)
    m.connect(a, snk)
    m.connect(b, snk)
    return m


def lossy(mod, horizon_s=20.0):
    """A lossy line edge with a loss window into a server, then a random
    router whose targets are a lossy 5 ms edge to a server and a lossy
    edge to the sink; the second server exits on a lossy sink edge."""
    m = mod.EnsembleModel(horizon_s=horizon_s, transit_capacity=8)
    src = m.source(rate=8.0)
    a = m.server(service_mean=0.05, queue_capacity=64)
    b = m.server(service_mean=0.05, queue_capacity=64)
    router = m.router(policy="random")
    snk = m.sink()
    m.connect(src, a, loss_p=0.2, loss_window=(4.0, 12.0))
    m.connect(a, router)
    m.connect(router, b, latency_s=0.005, loss_p=0.1)
    m.connect(router, snk, loss_p=0.3)
    m.connect(b, snk, loss_p=0.05)
    return m


def bench_chaos(mod, horizon_s=40.0, n_servers=4, mu=10.0):
    """bench.py:855 bench_kernel_chaos's model without its telemetry:
    a limiter before a round-robin over 4 servers with correlated
    outage-mode faults, backoff 0.02 s with jitter 0.5 and 2 retries,
    hedges on the even servers, 5 ms edges with 5% loss on the even
    ones, transit capacity 16."""
    m = mod.EnsembleModel(horizon_s=horizon_s, transit_capacity=16)
    m.macro_block = 32
    src = m.source(rate=9.5)
    lim = m.limiter(refill_rate=1.3 * 0.95 * n_servers * mu, capacity=16.0)
    servers = [
        m.server(
            concurrency=1, service_mean=1.0 / mu, queue_capacity=256, max_retries=2,
            retry_backoff_s=0.02, retry_jitter=0.5,
            hedge_delay_s=0.3 / mu if index % 2 == 0 else None,
            fault=mod.FaultSpec(rate=0.05, mean_duration_s=0.5, correlated=True),
        )
        for index in range(n_servers)
    ]
    m.correlated_outages(rate=0.02, mean_duration_s=0.5, trigger_p=0.5)
    router = m.router(policy="round_robin")
    snk = m.sink()
    m.connect(src, lim)
    m.connect(lim, router)
    for index, server in enumerate(servers):
        m.connect(
            router, server, latency_s=0.005,
            latency_kind="exponential" if index % 2 else "constant",
            loss_p=0.05 if index % 2 == 0 else 0.0,
        )
        m.connect(server, snk)
    return m


CHAOS_MODELS = {
    "deadline-mm1": deadline_mm1,
    "backoff-chain": backoff_chain,
    "hedged-mm1": hedged,
    "hedged-erlang2": lambda mod: hedged(mod, "erlang", service_k=2),
    "brownout": brownout,
    "pinned": pinned,
    "stochastic": stochastic,
    "correlated": correlated,
    "lossy": lossy,
    "bench-chaos": lambda mod: bench_chaos(mod, horizon_s=10.0),
}
