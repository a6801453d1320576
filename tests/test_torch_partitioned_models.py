"""Partitioned models (remote egress nodes around a ring of partitions),
built with the same code in both packages (``mod`` is either package's
model module), at the sizes the CPU tests run.

This module holds no test and imports neither package, so the CPU parity
tests (test_torch_partitioned*.py) and the card's tests
(test_torch_gpu.py, run where JAX is not installed) share it."""

LAM, MU, HOP_S = 5.0, 20.0, 0.05


def ring(mod, horizon_s=5.0, rate=LAM):
    """The JAX package's example ring (examples/tpu/partitioned_ring.py):
    each partition a Poisson source -> a server (mu = 20, queue 256) -> a
    random router over [sink, remote into the neighbour's server after
    50 ms]. The product form: 2 / (mu - 2 lam) + hop = 0.25 s."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=rate)
    srv = m.server(service_mean=1.0 / MU, queue_capacity=256)
    snk = m.sink()
    remote = m.remote(ingress=srv, latency_s=HOP_S)
    router = m.router(policy="random")
    m.connect(src, srv)
    m.connect(srv, router)
    m.connect(router, snk)
    m.connect(router, remote)
    return m


def chaos_ring(mod, horizon_s=5.0):
    """The ring with chaos on its server: a brownout window over the
    second fifth of the horizon, a 0.3 s deadline with two retries after a
    20 ms backoff (retries park in the transit registers beside the jobs
    the neighbour sends)."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=8.0)
    srv = m.server(
        service_mean=1.0 / MU, queue_capacity=256, deadline_s=0.3, max_retries=2,
        retry_backoff_s=0.02, outage=(horizon_s / 5, 2 * horizon_s / 5),
    )
    snk = m.sink()
    remote = m.remote(ingress=srv, latency_s=HOP_S)
    router = m.router(policy="random")
    m.connect(src, srv)
    m.connect(srv, router)
    m.connect(router, snk)
    m.connect(router, remote)
    return m


def two_sink_ring(mod, horizon_s=5.0):
    """Two tenants a partition (the code for several sources and sinks):
    a Poisson 4/s source -> server 0 -> random over [sink 0, remote into
    the neighbour's server 0], and a constant 3/s source -> server 1 ->
    random over [sink 1 behind a 10 ms exponential edge, remote into the
    neighbour's server 1 after 80 ms]."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    sources = (m.source(rate=4.0), m.source(rate=3.0, kind="constant"))
    servers = (m.server(service_mean=0.04, queue_capacity=128),
               m.server(service_mean=0.05, queue_capacity=128))
    sinks = (m.sink(), m.sink())
    remotes = (m.remote(ingress=servers[0], latency_s=HOP_S),
               m.remote(ingress=servers[1], latency_s=0.08))
    for i, (src, srv, snk, remote) in enumerate(zip(sources, servers, sinks, remotes)):
        router = m.router(policy="random")
        m.connect(src, srv)
        m.connect(srv, router)
        if i == 0:
            m.connect(router, snk)
        else:
            m.connect(router, snk, latency_s=0.01, latency_kind="exponential")
        m.connect(router, remote)
    return m


def relay(mod, horizon_s=5.0):
    """Straight remote edges: a source -> server 0 -> remote into the
    neighbour's server 1 (every job crosses), whose server 1 -> a random
    router over [the sink, a remote back into the neighbour's server 0
    after 80 ms]; server 1 runs two slots of erlang-2 service (the family
    sampler)."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=6.0)
    first = m.server(service_mean=0.03, queue_capacity=128)
    second = m.server(service_mean=0.08, service="erlang", service_k=2, concurrency=2,
                      queue_capacity=128)
    snk = m.sink()
    m.connect(src, first)
    m.connect(first, m.remote(ingress=second, latency_s=HOP_S))
    router = m.router(policy="random")
    m.connect(second, router)
    m.connect(router, snk)
    m.connect(router, m.remote(ingress=first, latency_s=0.08))
    return m


def wide_ring(mod, horizon_s=5.0, stages=9):
    """The ring through a chain of nine servers (past the lean tables'
    eight: the wide code): a source -> nine stages -> a random router over
    [sink, remote into the neighbour's first stage]."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=4.0)
    servers = [m.server(service_mean=0.01, queue_capacity=64) for _ in range(stages)]
    m.connect(src, servers[0])
    for a, b in zip(servers, servers[1:]):
        m.connect(a, b)
    router = m.router(policy="random")
    m.connect(servers[-1], router)
    m.connect(router, m.sink())
    m.connect(router, m.remote(ingress=servers[0], latency_s=HOP_S))
    return m


PARTITIONED_MODELS = {
    "ring": ring,
    "chaos-ring": chaos_ring,
    "two-sink-ring": two_sink_ring,
    "relay": relay,
    "wide-ring": wide_ring,
}
