"""Resilience models built with the same code in both packages (``mod`` is
either package's model module): circuit breakers, load shedding and
retry budgets, each taken from the JAX package's own tests and benches,
at the sizes the CPU tests run.

This module holds no test and imports neither package, so the CPU parity
tests (test_torch_resilience.py) and the card's tests (test_torch_gpu.py,
run where JAX is not installed) share it."""

import numpy as np

from test_torch_telemetry_models import chaos_fanout, faulted_telemetry_chain

# tests/integration/test_tpu_resilience.py's storm: an M/M/1 at rho=0.64
# (mu=50, lambda=32) with deadline retries and a pinned outage.
STORM_MU, STORM_LAM = 50.0, 32.0
STORM_OUTAGE = (2.0, 4.0)
STORM_REPLICAS, STORM_MAX_EVENTS = 32, 6144


def storm(mod, defended: bool, horizon_s: float = 12.0):
    """test_tpu_resilience.py:48 _storm_model: deadline 0.25 s, 3 retries
    after a 0.5 s backoff, the outage [2, 4) pinned in every replica, 1 s
    windows of throughput and rates. Undefended, the post-outage retry
    herd keeps the queue saturated and goodput never recovers; defended
    (breaker 5 in 1 s, cooldown 0.5 s, 2 probes; budget 0.1 per request,
    0.5/s, burst 4), it recovers."""
    m = mod.EnsembleModel(horizon_s=horizon_s, transit_capacity=64)
    src = m.source(rate=STORM_LAM)
    srv = m.server(
        service_mean=1.0 / STORM_MU, queue_capacity=512, deadline_s=0.25, max_retries=3,
        retry_backoff_s=0.5, fault=mod.FaultSpec(windows=(STORM_OUTAGE,)),
    )
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    m.telemetry(window_s=1.0, metrics=("throughput", "rates"))
    if defended:
        m.circuit_breaker(failure_threshold=5, window_s=1.0, cooldown_s=0.5, half_open_probes=2)
        m.retry_budget(ratio=0.1, min_per_s=0.5, burst=4.0)
    return m


def cascade(mod):
    """test_tpu_resilience.py:191 _cascade_model: source -> A -> B -> sink,
    B browned out over [3, 4); B's breaker (4 in 0.5 s, cooldown 0.4 s,
    1 probe) trips on the brownout drops and re-closes after it."""
    m = mod.EnsembleModel(horizon_s=10.0)
    src = m.source(rate=20.0)
    first = m.server(service_mean=1.0 / STORM_MU, queue_capacity=128)
    second = m.server(service_mean=1.0 / STORM_MU, queue_capacity=128, outage=(3.0, 4.0))
    snk = m.sink()
    m.connect(src, first)
    m.connect(first, second)
    m.connect(second, snk)
    m.telemetry(window_s=1.0, metrics=("throughput", "rates"))
    m.circuit_breaker(failure_threshold=4, window_s=0.5, cooldown_s=0.4, half_open_probes=1)
    return m


def shed(mod, policy: str, **kwargs):
    """test_tpu_resilience.py:260 _shed_model: lambda=40 into 2 slots of
    mean 0.1 s and a 16-place queue, horizon 4 s, shed by ``policy``."""
    m = mod.EnsembleModel(horizon_s=4.0)
    src = m.source(rate=40.0)
    srv = m.server(service_mean=0.1, concurrency=2, queue_capacity=16)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    m.load_shed(policy=policy, **kwargs)
    return m


def hedge_budget(mod, budget: bool = True):
    """test_tpu_resilience.py:320 TestHedgeBudget._hedge_model: a hedged
    (0.05 s) overloaded M/M/1, lambda=20, mean 0.1, horizon 6 s; the
    budget (ratio 0, 0.5/s, burst 2) suppresses most hedges once its
    burst is spent, at both start paths."""
    m = mod.EnsembleModel(horizon_s=6.0)
    src = m.source(rate=20.0)
    srv = m.server(service_mean=0.1, queue_capacity=64, hedge_delay_s=0.05)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    if budget:
        m.retry_budget(ratio=0.0, min_per_s=0.5, burst=2.0)
    return m


def resilience_fanout(mod):
    """tests/unit/test_kernel_event_step.py:161 _resilience_fanout: the
    chaos fan-out with telemetry, a breaker (2 in 0.5 s, cooldown 0.3 s,
    1 probe), a queue-depth shed at 2 exempting a quarter of the traffic,
    and a budget (0.2 per request, 0.5/s, burst 2)."""
    m = chaos_fanout(mod)
    m.circuit_breaker(failure_threshold=2, window_s=0.5, cooldown_s=0.3, half_open_probes=1)
    m.load_shed(policy="queue_depth", threshold=2, priority_fraction=0.25)
    m.retry_budget(ratio=0.2, min_per_s=0.5, burst=2.0)
    return m


# tests/unit/test_kernel_event_step.py:344-352, the breaker matrix's corners.
BREAKER_CORNERS = {
    "trip-on-first": dict(failure_threshold=1, window_s=0.2, cooldown_s=0.2, half_open_probes=1),
    "sliding-3": dict(failure_threshold=3, window_s=0.5, cooldown_s=0.3, half_open_probes=2),
    "wide-5": dict(failure_threshold=5, window_s=1.0, cooldown_s=0.5, half_open_probes=4),
}


def breaker_matrix(mod, corner: str):
    """test_block_kernel_breaker_matrix's model: the faulted telemetry
    chain with a 0.3 s deadline on its first server and the corner's
    breaker."""
    m = faulted_telemetry_chain(mod)
    m.servers[0].deadline_s = 0.3
    m.circuit_breaker(**BREAKER_CORNERS[corner])
    return m


# bench.py:1050 bench_resilience: mu=25, 16 windows, the outage over
# [0.3, 0.45) of the horizon, the source swept over linspace(0.45, 0.7) x mu.
BENCH_MU, BENCH_WINDOWS = 25.0, 16


def bench_resilience(mod, defended: bool, horizon_s: float = 40.0):
    """bench.py:1084 bench_resilience's model: the deadline M/M/1 (0.5 s,
    3 retries after a 1 s backoff) behind a pinned outage, 16 windows of
    throughput and rates; defended, a breaker (5 in 1 s, cooldown 0.5 s,
    2 probes) and a budget (0.1, 0.5/s, burst 4)."""
    m = mod.EnsembleModel(horizon_s=horizon_s, transit_capacity=64)
    m.macro_block = 32
    src = m.source(rate=0.6 * BENCH_MU)
    srv = m.server(
        concurrency=1, service_mean=1.0 / BENCH_MU, queue_capacity=512, deadline_s=0.5,
        max_retries=3, retry_backoff_s=1.0,
        fault=mod.FaultSpec(windows=((0.3 * horizon_s, 0.45 * horizon_s),)),
    )
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    m.telemetry(window_s=horizon_s / BENCH_WINDOWS, metrics=("throughput", "rates"))
    if defended:
        m.circuit_breaker(failure_threshold=5, window_s=1.0, cooldown_s=0.5, half_open_probes=2)
        m.retry_budget(ratio=0.1, min_per_s=0.5, burst=4.0)
    return m


def bench_resilience_sweep(n: int) -> dict:
    """bench_resilience's rho sweep over ``n`` replicas."""
    return {
        "source_rate": np.linspace(0.45 * BENCH_MU, 0.7 * BENCH_MU, n).astype(np.float32)
    }


def bench_resilience_max_events(horizon_s: float = 40.0) -> int:
    """bench_resilience's event budget (bench.py:1121)."""
    return int(12.0 * 0.7 * BENCH_MU * horizon_s) + 64


def immediate_budget(mod):
    """A deadline M/M/1 with immediate (tail re-enqueue) retries whose
    budget refills at a rate that is no power of two (0.3/s, ratio 0.2,
    burst 3), so the refill's multiply-add rounds differently once or
    twice; a 3-slot utilisation shed at 2/3 sheds at 2 busy slots."""
    m = mod.EnsembleModel(horizon_s=10.0, warmup_s=1.0)
    src = m.source(rate=28.0)
    srv = m.server(
        concurrency=3, service_mean=0.1, queue_capacity=8, deadline_s=0.15, max_retries=2
    )
    m.connect(src, srv)
    m.connect(srv, m.sink())
    m.retry_budget(ratio=0.2, min_per_s=0.3, burst=3.0)
    m.load_shed(policy="utilization", threshold=2.0 / 3.0)
    return m


RESILIENCE_MODELS = {
    "storm-undefended": lambda mod: storm(mod, False),
    "storm-defended": lambda mod: storm(mod, True),
    "cascade": cascade,
    "shed-queue-depth": lambda mod: shed(mod, "queue_depth", threshold=4),
    "shed-utilization": lambda mod: shed(mod, "utilization", threshold=1.0),
    "shed-priority": lambda mod: shed(mod, "queue_depth", threshold=2, priority_fraction=0.5),
    "hedge-budget": hedge_budget,
    "resilience-fanout": resilience_fanout,
    **{f"breaker-{corner}": (lambda mod, corner=corner: breaker_matrix(mod, corner)) for corner in BREAKER_CORNERS},
    "bench-defended": lambda mod: bench_resilience(mod, True),
    "immediate-budget": immediate_budget,
}
# The models whose source rate bench.py sweeps per replica.
SWEPT = {"bench-defended": bench_resilience_sweep}
