"""Model specs for the ensemble engine (own copy of the builder subset of
``happysim_tpu/tpu/model.py``).

Build a model exactly as with the JAX package::

    m = EnsembleModel(horizon_s=60.0, warmup_s=10.0)
    src = m.source(rate=8.0, kind="poisson")
    srv = m.server(concurrency=1, service_mean=0.1, queue_capacity=64)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)

The port runs single-source, single-sink server chains: Poisson or
constant sources (with ``stop_after_s``), servers of any concurrency and
queue capacity with constant or exponential service, zero-latency edges,
``warmup_s`` and ``macro_block``. Every other feature of the JAX builder
raises :class:`NotImplementedError` naming itself and the ROADMAP item
that ports it; the port has no second engine to fall back to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

SOURCE = "source"
SERVER = "server"
SINK = "sink"

ARRIVAL_KINDS = ("poisson", "constant")
#: Service families the port runs (JAX kind ids 0 and 1).
SERVICE_KINDS = ("constant", "exponential")
#: Service families of the JAX package that are not ported yet.
UNPORTED_SERVICE_KINDS = ("erlang", "hyperexp", "lognormal", "pareto")

# Builder features of the JAX package outside this port, each with the
# ROADMAP item that ports it. Reaching one raises NotImplementedError.
_UNPORTED = {
    "router": "routers (ROADMAP A.5)",
    "limiter": "token-bucket limiters (ROADMAP A.5)",
    "ramp_source": "rate profiles (ROADMAP A.5)",
    "spike_source": "rate profiles (ROADMAP A.5)",
    "telemetry": "windowed telemetry (ROADMAP A.7)",
    "correlated_outages": "correlated outages (ROADMAP A.7)",
    "circuit_breaker": "circuit breakers (ROADMAP A.8)",
    "load_shed": "load shedding (ROADMAP A.8)",
    "retry_budget": "retry budgets (ROADMAP A.8)",
    "network_partition": "network partitions (ROADMAP A.11)",
    "quorum": "quorum groups (ROADMAP A.11)",
    "leader_election": "leader election (ROADMAP A.11)",
    "trace_arrivals": "trace-driven arrivals (ROADMAP A.12)",
    "remote": "remote egress nodes (ROADMAP A.14)",
}
_UNPORTED_SERVER_ARGS = {
    "deadline_s": "deadlines (ROADMAP A.6)",
    "max_retries": "retries (ROADMAP A.6)",
    "retry_backoff_s": "backoff retries (ROADMAP A.6)",
    "retry_jitter": "retry jitter (ROADMAP A.6)",
    "hedge_delay_s": "hedged requests (ROADMAP A.6)",
    "service_k": "the erlang service family (ROADMAP A.5)",
    "service_scv": "the hyperexp/lognormal service families (ROADMAP A.5)",
    "pareto_alpha": "the pareto service family (ROADMAP A.5)",
    "outage": "brownout windows (ROADMAP A.7)",
    "fault": "fault schedules (ROADMAP A.7)",
}


def not_ported(feature: str) -> NotImplementedError:
    """The error every out-of-slice feature raises."""
    return NotImplementedError(
        f"{feature} are not ported to happysim_tpu_torch yet"
    )


@dataclass(frozen=True)
class NodeRef:
    kind: str
    index: int


@dataclass(frozen=True)
class EdgeLatency:
    """Link latency of an edge; the port runs zero-latency edges only."""

    mean_s: float = 0.0
    kind: str = "constant"


@dataclass
class SourceSpec:
    rate: float
    arrival: str = "poisson"
    stop_after_s: Optional[float] = None
    downstream: Optional[NodeRef] = None
    latency: EdgeLatency = field(default_factory=EdgeLatency)


@dataclass
class ServerSpec:
    concurrency: int = 1
    service_mean_s: float = 0.1
    service: str = "exponential"
    queue_capacity: int = 64
    downstream: Optional[NodeRef] = None
    latency: EdgeLatency = field(default_factory=EdgeLatency)


@dataclass
class SinkSpec:
    pass


class EnsembleModel:
    """Static topology of a single-source, single-sink server chain.

    ``warmup_s`` masks statistics before the cutoff (sink latencies,
    server waits, utilization and queue-depth integrals); server
    started/completed/dropped counters stay whole-run. ``macro_block`` is
    the number of fused event steps per kernel launch and per RNG chunk
    (None = 32); it is part of the RNG stream layout.
    """

    def __init__(
        self,
        horizon_s: float = 60.0,
        warmup_s: float = 0.0,
        macro_block: Optional[int] = None,
    ):
        if warmup_s < 0.0 or warmup_s >= horizon_s:
            raise ValueError("warmup_s must satisfy 0 <= warmup_s < horizon_s")
        if macro_block is not None and macro_block < 1:
            raise ValueError("macro_block must be >= 1 (or None for default)")
        self.horizon_s = horizon_s
        self.warmup_s = warmup_s
        self.macro_block = macro_block
        self.sources: list[SourceSpec] = []
        self.servers: list[ServerSpec] = []
        self.sinks: list[SinkSpec] = []

    def __getattr__(self, name: str):
        if name in _UNPORTED:
            raise not_ported(_UNPORTED[name])
        raise AttributeError(name)

    # -- builders ----------------------------------------------------------
    def source(
        self,
        rate: float,
        kind: str = "poisson",
        stop_after_s: Optional[float] = None,
        profile=None,
    ) -> NodeRef:
        if kind not in ARRIVAL_KINDS:
            raise ValueError(f"arrival kind {kind!r} not in {ARRIVAL_KINDS}")
        if profile is not None:
            raise not_ported("rate profiles (ROADMAP A.5)")
        self.sources.append(
            SourceSpec(rate=rate, arrival=kind, stop_after_s=stop_after_s)
        )
        return NodeRef(SOURCE, len(self.sources) - 1)

    def server(
        self,
        concurrency: int = 1,
        service_mean: float = 0.1,
        service: str = "exponential",
        queue_capacity: int = 64,
        **unported,
    ) -> NodeRef:
        for name in unported:
            if name not in _UNPORTED_SERVER_ARGS:
                raise TypeError(f"server() got an unexpected argument {name!r}")
            raise not_ported(_UNPORTED_SERVER_ARGS[name])
        if service in UNPORTED_SERVICE_KINDS:
            raise not_ported(f"{service} service times (ROADMAP A.5)")
        if service not in SERVICE_KINDS:
            raise ValueError(f"service kind {service!r} not in {SERVICE_KINDS}")
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        self.servers.append(
            ServerSpec(
                concurrency=concurrency,
                service_mean_s=service_mean,
                service=service,
                queue_capacity=queue_capacity,
            )
        )
        return NodeRef(SERVER, len(self.servers) - 1)

    def sink(self) -> NodeRef:
        self.sinks.append(SinkSpec())
        return NodeRef(SINK, len(self.sinks) - 1)

    # -- wiring ------------------------------------------------------------
    def connect(
        self,
        origin: NodeRef,
        downstream: NodeRef,
        latency_s: float = 0.0,
        latency_kind: str = "constant",
        loss_p: float = 0.0,
        loss_window: Optional[tuple] = None,
    ) -> None:
        """Wire ``origin`` -> ``downstream`` with a zero-latency edge."""
        if latency_s < 0:
            raise ValueError("latency_s must be >= 0")
        if latency_s > 0:
            raise not_ported("latency edges (ROADMAP A.5)")
        if loss_p > 0.0 or loss_window is not None:
            raise not_ported("packet-loss edges (ROADMAP A.7)")
        edge = EdgeLatency(mean_s=latency_s, kind=latency_kind)
        if origin.kind == SOURCE:
            self.sources[origin.index].downstream = downstream
            self.sources[origin.index].latency = edge
        elif origin.kind == SERVER:
            self.servers[origin.index].downstream = downstream
            self.servers[origin.index].latency = edge
        elif origin.kind == SINK:
            raise ValueError("Sinks have no downstream")
        else:
            raise not_ported(f"{origin.kind} nodes (ROADMAP A.5)")

    # -- validation --------------------------------------------------------
    def validate(self) -> None:
        """Check the model is a chain the port runs; raise
        NotImplementedError for every feature it does not run yet."""
        if not self.sources:
            raise ValueError("Model needs at least one source")
        if not self.sinks:
            raise ValueError("Model needs at least one sink")
        if len(self.sources) > 1:
            raise not_ported("models with several sources (ROADMAP A.5)")
        if len(self.sinks) > 1:
            raise not_ported("models with several sinks (ROADMAP A.5)")
        for i, source in enumerate(self.sources):
            if source.downstream is None:
                raise ValueError(f"source[{i}] has no downstream")
            if source.arrival not in ARRIVAL_KINDS:
                raise ValueError(f"source[{i}]: arrival kind {source.arrival!r}")
        for i, server in enumerate(self.servers):
            if server.downstream is None:
                raise ValueError(f"server[{i}] has no downstream")
            if server.service in UNPORTED_SERVICE_KINDS:
                raise not_ported(f"{server.service} service times (ROADMAP A.5)")
            if server.service not in SERVICE_KINDS:
                raise ValueError(f"server[{i}]: service kind {server.service!r}")
        for edge in self.iter_edges():
            if edge.mean_s > 0:
                raise not_ported("latency edges (ROADMAP A.5)")
        refs = [s.downstream for s in self.sources] + [
            s.downstream for s in self.servers
        ]
        for ref in refs:
            if ref.kind not in (SERVER, SINK):
                raise not_ported(f"{ref.kind} nodes (ROADMAP A.5)")
        self.chain_order()

    def chain_order(self) -> list[int]:
        """Server indices in the order a job visits them (source to sink).

        Raises when the servers do not form one path from the source to
        the sink: a source wired straight to the sink, a feedback loop,
        or a server off the path."""
        order: list[int] = []
        ref = self.sources[0].downstream
        while ref.kind == SERVER:
            if ref.index in order:
                raise not_ported("feedback loops between servers (ROADMAP A.5)")
            order.append(ref.index)
            ref = self.servers[ref.index].downstream
        if not order:
            raise not_ported("sources wired straight to a sink (ROADMAP A.5)")
        off_path = sorted(set(range(len(self.servers))) - set(order))
        if off_path:
            raise not_ported(
                "servers outside the source->sink chain "
                f"({', '.join(f'server[{i}]' for i in off_path)}; ROADMAP A.5)"
            )
        return order

    def iter_edges(self):
        for s in self.sources:
            yield s.latency
        for v in self.servers:
            yield v.latency

    @property
    def max_concurrency(self) -> int:
        return max((s.concurrency for s in self.servers), default=1)

    @property
    def max_queue_capacity(self) -> int:
        return max((s.queue_capacity for s in self.servers), default=1)


def pipeline_model(
    rate: float,
    service_means: Sequence[float],
    horizon_s: float = 60.0,
    queue_capacity: int = 512,
    concurrency: int = 1,
    kind: str = "poisson",
) -> EnsembleModel:
    """A tandem queueing network: source -> server chain -> sink."""
    if not service_means:
        raise ValueError("pipeline_model needs at least one stage")
    model = EnsembleModel(horizon_s=horizon_s)
    src = model.source(rate=rate, kind=kind)
    stages = [
        model.server(
            concurrency=concurrency,
            service_mean=mean,
            queue_capacity=queue_capacity,
        )
        for mean in service_means
    ]
    snk = model.sink()
    model.connect(src, stages[0])
    for upstream, downstream in zip(stages, stages[1:]):
        model.connect(upstream, downstream)
    model.connect(stages[-1], snk)
    return model


def mm1_model(lam: float = 8.0, mu: float = 10.0, horizon_s: float = 60.0,
              queue_capacity: int = 256, warmup_s: float = 0.0) -> EnsembleModel:
    """The canonical M/M/1 (the oracle workload: mean wait rho/(mu-lam),
    mean sojourn 1/(mu-lam))."""
    model = EnsembleModel(horizon_s=horizon_s, warmup_s=warmup_s)
    src = model.source(rate=lam, kind="poisson")
    srv = model.server(concurrency=1, service_mean=1.0 / mu, queue_capacity=queue_capacity)
    snk = model.sink()
    model.connect(src, srv)
    model.connect(srv, snk)
    return model
