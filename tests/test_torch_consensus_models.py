"""Consensus models (network partitions, a write quorum, leader
election) built with the same code in both packages (``mod`` is either
package's model module): tests/integration/test_tpu_consensus.py's
scenarios and two more, at the sizes the CPU tests run.

This module holds no test and imports neither package, so the CPU
parity tests (test_torch_consensus.py, test_torch_consensus_runs.py) and
the card's tests (test_torch_gpu.py, run where JAX is not installed)
share it."""

# Models, built with the same code in both packages (``mod`` is either
# package's model module).
def quorum_loss(mod, defended: bool, horizon_s: float = 12.0):
    """tests/integration/test_tpu_consensus.py's scenario A: a constant
    6/s source round-robin over 3 servers behind 10 ms edges, backoff
    retries, 1 s windows, one pinned cut of servers 1 and 2 over [4, 6)
    and a write quorum of 2 of the 3; the defended arm adds a breaker and
    a retry budget."""
    model = mod.EnsembleModel(horizon_s=horizon_s, macro_block=8, transit_capacity=16)
    src = model.source(rate=6.0, kind="constant")
    servers = [
        model.server(
            service_mean=0.1, queue_capacity=16, max_retries=3, retry_backoff_s=0.1,
            retry_jitter=0.5,
        )
        for _ in range(3)
    ]
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, router)
    for server in servers:
        model.connect(router, server, latency_s=0.01, latency_kind="constant")
        model.connect(server, snk)
    model.telemetry(window_s=1.0)
    model.network_partition(group=[servers[1], servers[2]], windows=((4.0, 6.0),))
    model.quorum(servers, write=2, read=2)
    if defended:
        model.circuit_breaker(failure_threshold=3, window_s=0.5, cooldown_s=0.5, half_open_probes=1)
        model.retry_budget(ratio=0.1, min_per_s=0.5, burst=2.0)
    return model


CUT_HIGH = ((2.0, 4.0), (6.0, 8.0), (10.0, 12.0))
CUT_MID = ((4.0, 6.0), (8.0, 10.0))


def election_storm(mod, strategy: str, horizon_s: float = 12.0):
    """Scenario B: back-to-back 2 s cuts alternating between the two
    highest members, one election per flap, with 1 s windows."""
    model = mod.EnsembleModel(horizon_s=horizon_s, macro_block=8)
    src = model.source(rate=2.0, kind="constant")
    servers = [model.server(service_mean=0.05, queue_capacity=8) for _ in range(3)]
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, router)
    for server in servers:
        model.connect(router, server)
        model.connect(server, snk)
    model.telemetry(window_s=1.0)
    model.network_partition(group=[servers[2]], windows=CUT_HIGH)
    model.network_partition(group=[servers[1]], windows=CUT_MID)
    model.leader_election(servers, heartbeat_s=0.4, timeout_s=1.5, strategy=strategy)
    return model


def stochastic(mod, horizon_s: float = 12.0):
    """A stochastic correlated cut (Exp gaps at 0.3/s, Exp durations of
    mean 1 s, each candidate firing with probability 0.7) of servers 0 and
    1 of a Poisson 8/s random fan-out over 3 servers; a quorum of 2 and a
    bully election over all three, and a drop-mode fault schedule on
    server 2 (the members' dark windows mix both sources)."""
    model = mod.EnsembleModel(horizon_s=horizon_s, macro_block=16)
    src = model.source(rate=8.0)
    servers = [
        model.server(service_mean=0.08, queue_capacity=16),
        model.server(service_mean=0.08, queue_capacity=16),
        model.server(
            service_mean=0.08, queue_capacity=16,
            fault=mod.FaultSpec(rate=0.2, mean_duration_s=0.5, max_windows=6),
        ),
    ]
    router = model.router(policy="random")
    snk = model.sink()
    model.connect(src, router)
    for server in servers:
        model.connect(router, server)
        model.connect(server, snk)
    model.network_partition(
        group=servers[:2], rate=0.3, mean_duration_s=1.0, trigger_p=0.7, max_windows=6
    )
    model.quorum(servers, write=2, read=2)
    model.leader_election(servers, heartbeat_s=0.2, timeout_s=0.5)
    return model


def delay_mode(mod, horizon_s: float = 12.0):
    """Delay-mode cuts: a source into server 0 over a 20 ms exponential
    edge, server 0 -> a random router over servers 1 and 2 -> sink; server
    0 delayed 0.25 s in [2, 5) and servers 1, 2 delayed 0.1 s in [3, 4)
    and [7, 9), and server 2 also in a drop-mode cut over [8, 8.5) (drop
    wins)."""
    model = mod.EnsembleModel(horizon_s=horizon_s)
    src = model.source(rate=6.0)
    front = model.server(service_mean=0.05, queue_capacity=32)
    back = [model.server(service_mean=0.1, queue_capacity=32) for _ in range(2)]
    router = model.router(policy="random")
    snk = model.sink()
    model.connect(src, front, latency_s=0.02, latency_kind="exponential")
    model.connect(front, router)
    for server in back:
        model.connect(router, server)
        model.connect(server, snk)
    model.network_partition(group=[front], windows=((2.0, 5.0),), mode="delay", delay_s=0.25)
    model.network_partition(group=back, windows=((3.0, 4.0), (7.0, 9.0)), mode="delay", delay_s=0.1)
    model.network_partition(group=[back[1]], windows=((8.0, 8.5),))
    return model


CONSENSUS_MODELS = {
    "quorum-undefended": lambda mod: quorum_loss(mod, False),
    "quorum-defended": lambda mod: quorum_loss(mod, True),
    "election-bully": lambda mod: election_storm(mod, "bully"),
    "election-phi": lambda mod: election_storm(mod, "phi_accrual"),
    "stochastic": stochastic,
    "delay": delay_mode,
}
