"""Telemetry models built with the same code in both packages (``mod`` is
either package's model module), at the sizes the CPU tests run.

This module holds no test and imports neither package, so the CPU parity
tests (test_torch_telemetry.py, test_torch_event_step.py) and the card's
tests (test_torch_gpu.py, run where JAX is not installed) share it."""

from test_torch_chaos_models import bench_chaos


def mm1_all(mod, horizon_s=20.0):
    """The M/M/1 (lambda=8, mu=10, warmup 5 s) with every metric group,
    2.5 s windows."""
    m = mod.mm1_model(8.0, 10.0, horizon_s, warmup_s=5.0)
    m.telemetry(window_s=2.5)
    return m


def chain_queue_util(mod, horizon_s=20.0):
    """The 3-stage pipeline with only the queue and utilization groups:
    no sink or counter buffer."""
    m = mod.pipeline_model(8.0, (0.05, 0.08, 0.06), horizon_s)
    m.telemetry(window_s=2.0, metrics=("queue", "utilization"))
    return m


def pareto(mod, horizon_s=20.0):
    """The pareto(3) M/G/1 of test_tpu_mg1.py (lambda=8, mean 0.1, queue
    512), 1 s windows: a long service spreads its busy time over many
    windows."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=5.0)
    src = m.source(rate=8.0)
    srv = m.server(service_mean=0.1, service="pareto", pareto_alpha=3.0, queue_capacity=512)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    m.telemetry(window_s=1.0)
    return m


def indivisible(mod):
    """Horizon 10 s in 3 s windows: the last window is 1 s short."""
    m = mod.mm1_model(8.0, 10.0, 10.0, warmup_s=1.0)
    m.telemetry(window_s=3.0)
    return m


def warmup_inside(mod, horizon_s=12.0):
    """test_tpu_telemetry.py's M/M/1: warmup 2 s inside the second 1.5 s
    window."""
    m = mod.mm1_model(8.0, 10.0, horizon_s, warmup_s=2.0)
    m.telemetry(window_s=1.5)
    return m


def _chain_with_transit(mod):
    m = mod.EnsembleModel(horizon_s=2.0)
    src = m.source(rate=4.0)
    first = m.server(service_mean=0.05, queue_capacity=8)
    second = m.server(service_mean=0.07, queue_capacity=8, service="erlang")
    snk = m.sink()
    m.connect(src, first, latency_s=0.02, latency_kind="exponential")
    m.connect(first, second, latency_s=0.01)
    m.connect(second, snk)
    return m


def faulted_telemetry_chain(mod):
    """tests/unit/test_kernel_event_step.py's _faulted_telemetry_chain:
    outage and degrade fault windows behind latency edges, 0.5 s
    windows over 2 s."""
    m = _chain_with_transit(mod)
    m.servers[0].fault = mod.FaultSpec(rate=0.8, mean_duration_s=0.2)
    m.servers[1].fault = mod.FaultSpec(
        rate=0.5, mean_duration_s=0.3, mode="degrade", latency_factor=2.0
    )
    m.telemetry(window_s=0.5)
    return m


def _router_fanout(mod, policy="random"):
    m = mod.EnsembleModel(horizon_s=2.0, transit_capacity=8)
    src = m.source(rate=6.0)
    servers = [m.server(service_mean=0.05, queue_capacity=8) for _ in range(4)]
    router = m.router(policy=policy)
    snk = m.sink()
    m.connect(src, router)
    edge_mix = [(0.01, "constant"), (0.02, "exponential"), (0.0, "constant")]
    for index, server in enumerate(servers):
        latency_s, kind = edge_mix[index % len(edge_mix)]
        m.connect(router, server, latency_s=latency_s, latency_kind=kind)
        m.connect(server, snk)
    return m


def router_faulted_telemetry(mod):
    """test_kernel_event_step.py's _router_faulted_telemetry: the
    round-robin fan-out over mixed edges with a faulted server."""
    m = _router_fanout(mod, "round_robin")
    m.servers[0].fault = mod.FaultSpec(rate=0.8, mean_duration_s=0.2)
    m.telemetry(window_s=0.5)
    return m


def chaos_fanout(mod):
    """test_kernel_event_step.py's _chaos_fanout: limiter, backoff retries
    with jitter, hedges, correlated outages, a brownout and lossy targets
    on the round-robin fan-out, 0.5 s windows."""
    m = mod.EnsembleModel(horizon_s=2.0, transit_capacity=8)
    src = m.source(rate=6.0)
    lim = m.limiter(refill_rate=8.0, capacity=4.0)
    servers = [
        m.server(
            service_mean=0.05, queue_capacity=8, deadline_s=0.6, max_retries=2,
            retry_backoff_s=0.05, retry_jitter=0.5,
            hedge_delay_s=0.15 if index % 2 == 0 else None,
            fault=mod.FaultSpec(rate=0.4, mean_duration_s=0.3, correlated=True) if index < 2 else None,
            outage=(0.8, 1.1) if index == 3 else None,
        )
        for index in range(4)
    ]
    m.correlated_outages(rate=0.3, mean_duration_s=0.3, trigger_p=0.5)
    router = m.router(policy="round_robin")
    snk = m.sink()
    m.connect(src, lim)
    m.connect(lim, router)
    edge_mix = [(0.01, "constant"), (0.02, "exponential"), (0.0, "constant")]
    for index, server in enumerate(servers):
        latency_s, kind = edge_mix[index % len(edge_mix)]
        m.connect(
            router, server, latency_s=latency_s, latency_kind=kind,
            loss_p=0.05 if index % 2 == 0 else 0.0,
        )
        m.connect(server, snk)
    m.telemetry(window_s=0.5)
    return m


def bench_telemetry(mod, horizon_s=40.0, windows=64):
    """bench.py:454 bench_kernel_telemetry's model: a faulted deadline
    M/M/1 (deadline 8 s, 2 immediate retries, outage windows at rate 0.05
    lasting 0.5 s), warmup a quarter of the horizon, 64 windows; the
    source rate is swept per replica by the caller. ``windows=0`` leaves
    the telemetry out."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=horizon_s / 4)
    m.macro_block = 32
    src = m.source(rate=9.5)
    srv = m.server(
        concurrency=1, service_mean=0.1, queue_capacity=256, deadline_s=8.0, max_retries=2,
        fault=mod.FaultSpec(rate=0.05, mean_duration_s=0.5),
    )
    m.connect(src, srv)
    m.connect(srv, m.sink())
    if windows:
        m.telemetry(window_s=horizon_s / windows)
    return m


def bench_chaos_telemetry(mod, horizon_s=10.0):
    """bench.py:855 bench_kernel_chaos's model with its telemetry line:
    64 windows over the horizon."""
    m = bench_chaos(mod, horizon_s=horizon_s)
    m.telemetry(window_s=horizon_s / 64)
    return m


def chaos_line(mod, window_s=2.0):
    """test_tpu_telemetry.py's _chaos_model: limiter admission, a latency
    edge, deadline retries, stochastic outage faults with backoff
    retries, a lossy sink edge, 2 s windows over 20 s. ``window_s=None``
    leaves the telemetry out."""
    m = mod.EnsembleModel(horizon_s=20.0)
    src = m.source(rate=6.0)
    lim = m.limiter(refill_rate=5.0, capacity=4.0)
    srv = m.server(
        concurrency=1, service_mean=0.12, queue_capacity=4, deadline_s=1.5, max_retries=2,
        fault=mod.FaultSpec(rate=0.2, mean_duration_s=1.0, mode="outage"),
        retry_backoff_s=0.05, retry_jitter=0.5,
    )
    snk = m.sink()
    m.connect(src, lim)
    m.connect(lim, srv, latency_s=0.01)
    m.connect(srv, snk, loss_p=0.05)
    if window_s is not None:
        m.telemetry(window_s=window_s)
    return m


def feedback(mod, window_s=1.0):
    """test_tpu_telemetry.py's feedback router: a server exits through a
    random router to the sink behind the model's only latency edge or
    back to itself. ``window_s=None`` leaves the telemetry out."""
    m = mod.EnsembleModel(horizon_s=10.0)
    src = m.source(rate=6.0)
    srv = m.server(service_mean=0.05, queue_capacity=32)
    snk = m.sink()
    rtr = m.router(policy="random")
    m.connect(src, srv)
    m.connect(srv, rtr)
    m.connect(rtr, snk, latency_s=0.02)
    m.connect(rtr, srv)
    if window_s is not None:
        m.telemetry(window_s=window_s)
    return m


TELEMETRY_MODELS = {
    "mm1-all": mm1_all,
    "chain-queue-util": chain_queue_util,
    "pareto": pareto,
    "indivisible": indivisible,
    "warmup-inside": warmup_inside,
    "faulted-chain": faulted_telemetry_chain,
    "router-faulted": router_faulted_telemetry,
    "chaos-fanout": chaos_fanout,
    "bench-telemetry": bench_telemetry,
    "bench-chaos": bench_chaos_telemetry,
    "chaos-line": chaos_line,
    "feedback": feedback,
}
