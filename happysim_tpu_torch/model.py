"""Model specs for the ensemble engine (own copy of the model-API subset of
``happysim_tpu/tpu/model.py``).

Build a model exactly as with the JAX package::

    m = EnsembleModel(horizon_s=60.0, warmup_s=10.0)
    src = m.source(rate=8.0, kind="poisson")
    lb = m.router(policy="round_robin")
    snk = m.sink()
    m.connect(src, lb)
    for _ in range(4):
        srv = m.server(concurrency=1, service_mean=0.1, queue_capacity=64)
        m.connect(lb, srv, latency_s=0.005)
        m.connect(srv, snk)

The port runs any graph of sources, sinks, servers, routers
(``random``, ``round_robin``, ``weighted``, ``least_outstanding``) and
token-bucket limiters that the JAX package's ``validate`` accepts, nodes
no source reaches and graphs with no path to a sink included: Poisson or
constant sources (with ``stop_after_s``), optionally shaped by a ramp or
spike :class:`RateProfile`, each wired to a server, a router, a limiter
or straight to a sink; servers of any concurrency and queue capacity with any of
the six service families (constant, exponential, erlang-2/3, balanced
hyperexponential, lognormal, mean-matched pareto), mixed freely;
zero-latency or latency-carrying edges (constant or exponential, parked
in ``transit_capacity`` in-flight slots per server), multi-tier router
DAGs, shared backends and "done or continue" feedback through a server,
``warmup_s`` and ``macro_block``. The chaos stack rides on any of them:
deadlines with immediate or backoff (jittered) retries, hedged requests,
brownout windows, stochastic or pinned :class:`FaultSpec` schedules in
outage or degrade mode, :meth:`EnsembleModel.correlated_outages`, and
per-crossing packet loss on edges (``connect(..., loss_p=...)``), and
the defenses against them: per-server circuit breakers
(:meth:`EnsembleModel.circuit_breaker`), admission load shedding
(:meth:`EnsembleModel.load_shed`) and retry budgets
(:meth:`EnsembleModel.retry_budget`), and the consensus tier: network
partition groups (:meth:`EnsembleModel.network_partition`), a write
quorum (:meth:`EnsembleModel.quorum`) and leader election
(:meth:`EnsembleModel.leader_election`). A source may replay a recorded
or synthesized arrival stream (:meth:`EnsembleModel.trace_arrivals`,
:mod:`~happysim_tpu_torch.traces`). Any of them may carry windowed
telemetry (``model.telemetry(window_s=...)``,
:mod:`~happysim_tpu_torch.telemetry`). Remote egress nodes
(:meth:`EnsembleModel.remote`) send jobs to the neighbour partition of a
partitioned run (:mod:`~happysim_tpu_torch.partitioned`); ``validate``
refuses them elsewhere, as the JAX package's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

from happysim_tpu_torch.telemetry import DEFAULT_METRICS, TelemetrySpec
from happysim_tpu_torch.traces import TraceSpec

SOURCE = "source"
SERVER = "server"
SINK = "sink"
ROUTER = "router"
LIMITER = "limiter"
REMOTE = "remote"

ARRIVAL_KINDS = ("poisson", "constant")
# Service-time families. Beyond M/M shapes, the M/G/1 set: Erlang-k
# (cv^2 = 1/k), balanced 2-phase hyperexponential (cv^2 = service_scv > 1),
# lognormal (cv^2 = service_scv), and mean-matched Pareto (pareto_alpha > 2
# for a finite-variance P-K oracle).
SERVICE_KINDS = ("exponential", "constant", "erlang", "hyperexp", "lognormal", "pareto")
ROUTER_POLICIES = ("random", "round_robin", "least_outstanding", "weighted")
LATENCY_KINDS = ("constant", "exponential")

@dataclass(frozen=True)
class NodeRef:
    kind: str
    index: int


@dataclass(frozen=True)
class RateProfile:
    """Time-varying arrival rate (host side; compiled to integral tables).

    Kinds:
      - ``constant``: rate(t) = base
      - ``ramp``: base -> ``end_rate`` linearly over ``ramp_duration_s``,
        then holds
      - ``spike``: base, except ``spike_rate`` inside
        [``spike_start_s``, ``spike_end_s``)
    """

    kind: str = "constant"
    end_rate: float = 0.0
    ramp_duration_s: float = 0.0
    spike_rate: float = 0.0
    spike_start_s: float = 0.0
    spike_end_s: float = 0.0

    def validate(self) -> None:
        """Kind + per-kind parameter checks; every error names the
        offending kind so a sweep over profiles reads unambiguously."""
        if self.kind not in ("constant", "ramp", "spike"):
            raise ValueError(
                f"unknown profile kind {self.kind!r} "
                "(valid kinds: 'constant', 'ramp', 'spike')"
            )
        if self.kind == "ramp":
            if self.ramp_duration_s <= 0.0:
                raise ValueError(
                    f"profile kind 'ramp': ramp_duration_s must be > 0, "
                    f"got {self.ramp_duration_s}"
                )
            if self.end_rate < 0.0:
                raise ValueError(
                    f"profile kind 'ramp': end_rate must be >= 0, "
                    f"got {self.end_rate}"
                )
        if self.kind == "spike":
            if self.spike_rate < 0.0:
                raise ValueError(
                    f"profile kind 'spike': spike_rate must be >= 0, "
                    f"got {self.spike_rate}"
                )
            if not 0.0 <= self.spike_start_s < self.spike_end_s:
                raise ValueError(
                    f"profile kind 'spike': need 0 <= spike_start_s < "
                    f"spike_end_s, got [{self.spike_start_s}, "
                    f"{self.spike_end_s})"
                )

    def rate_at(self, base_rate: float, t: float) -> float:
        if self.kind == "ramp":
            if self.ramp_duration_s <= 0:
                return self.end_rate
            frac = min(t / self.ramp_duration_s, 1.0)
            return base_rate + (self.end_rate - base_rate) * frac
        if self.kind == "spike":
            if self.spike_start_s <= t < self.spike_end_s:
                return self.spike_rate
            return base_rate
        return base_rate


@dataclass(frozen=True)
class EdgeLatency:
    """Link latency applied while a job crosses an edge.

    ``loss_p`` is a per-crossing Bernoulli packet-loss probability,
    active inside [``loss_start_s``, ``loss_end_s``). Lost jobs vanish
    (counted in ``EnsembleResult.network_lost``).
    """

    mean_s: float = 0.0
    kind: str = "constant"  # or "exponential"
    loss_p: float = 0.0
    loss_start_s: float = 0.0
    loss_end_s: float = float("inf")


@dataclass(frozen=True)
class FaultSpec:
    """Per-replica stochastic fault schedule for one server.

    Each replica draws its own timeline at init: inter-window gaps ~
    Exp(``rate``) measured from the end of the previous window, durations
    ~ Exp(``mean_duration_s``) or constant. The stationary dark fraction
    is ``mean_duration_s / (1/rate + mean_duration_s)``
    (:func:`happysim_tpu_torch.faults.duty_cycle`).

    ``mode`` selects the in-window effect: ``"outage"`` drops arrivals
    (client retries may send them again, see ``retry_backoff_s``);
    ``"degrade"`` keeps the server up with ``capacity_factor`` of its
    slots usable for new starts and every service started in-window
    inflated by ``latency_factor``. ``windows`` pins a deterministic
    schedule, identical in every replica. ``correlated=True`` also
    subscribes the server to the model's :class:`CorrelatedOutages`.
    ``max_windows`` bounds the compiled schedule; keep it above
    ``rate * horizon_s`` or late windows are never drawn.
    """

    rate: float = 0.0
    mean_duration_s: float = 0.0
    duration: str = "exponential"  # or "constant"
    mode: str = "outage"  # or "degrade"
    capacity_factor: float = 1.0
    latency_factor: float = 1.0
    correlated: bool = False
    max_windows: int = 4
    windows: Optional[tuple] = None  # ((start, end), ...) deterministic

    def validate(self, label: str) -> None:
        if self.mode not in ("outage", "degrade"):
            raise ValueError(f"{label}: fault mode {self.mode!r} not in "
                             "('outage', 'degrade')")
        if self.duration not in ("exponential", "constant"):
            raise ValueError(f"{label}: fault duration {self.duration!r} "
                             "not in ('exponential', 'constant')")
        if self.windows is not None:
            for start, end in self.windows:
                if start < 0.0 or end <= start:
                    raise ValueError(
                        f"{label}: fault window [{start}, {end}) is empty "
                        "or negative"
                    )
        else:
            if not self.correlated and self.rate <= 0.0:
                raise ValueError(f"{label}: stochastic fault needs rate > 0 "
                                 "(or explicit windows=..., or correlated=True)")
            # A correlated spec may carry its own stochastic windows on
            # top of the shared schedule; those need a positive duration.
            if self.rate > 0.0 and self.mean_duration_s <= 0.0:
                raise ValueError(f"{label}: fault needs mean_duration_s > 0")
        if self.max_windows < 1:
            raise ValueError(f"{label}: max_windows must be >= 1")
        if not 0.0 <= self.capacity_factor <= 1.0:
            raise ValueError(f"{label}: capacity_factor must be in [0, 1]")
        if self.latency_factor < 1.0:
            raise ValueError(f"{label}: latency_factor must be >= 1")
        if self.mode == "outage" and (
            self.capacity_factor != 1.0 or self.latency_factor != 1.0
        ):
            raise ValueError(
                f"{label}: capacity_factor/latency_factor require "
                "mode='degrade' (an outage drops arrivals outright)"
            )


@dataclass(frozen=True)
class CorrelatedOutages:
    """Model-level correlated-failure schedule (shared Bernoulli trigger).

    Each replica draws one shared sequence of candidate windows (gaps ~
    Exp(``rate``), durations ~ Exp(``mean_duration_s``)); each candidate
    fires with probability ``trigger_p``. While a fired window is open,
    every server whose :class:`FaultSpec` has ``correlated=True`` is dark
    at once.
    """

    rate: float
    mean_duration_s: float
    trigger_p: float = 1.0
    max_windows: int = 4

    def validate(self) -> None:
        if self.rate <= 0.0:
            raise ValueError("correlated_outages: rate must be > 0")
        if self.mean_duration_s <= 0.0:
            raise ValueError("correlated_outages: mean_duration_s must be > 0")
        if not 0.0 < self.trigger_p <= 1.0:
            raise ValueError("correlated_outages: trigger_p must be in (0, 1]")
        if self.max_windows < 1:
            raise ValueError("correlated_outages: max_windows must be >= 1")


@dataclass(frozen=True)
class CircuitBreakerSpec:
    """Per-(replica, server) closed -> open -> half-open state machine.

    Failures are fault-window rejections, brownout drops and deadline
    expiries. The failure window is exact: a ``(nV, failure_threshold)``
    ring of recent failure times trips the breaker when the
    ``failure_threshold`` most recent failures all landed within
    ``window_s``. While open, arrivals are rejected outright
    (``srv_breaker_dropped``, terminal: the fail-fast path spawns no
    retries). After ``cooldown_s`` the breaker reads as half-open: up to
    ``half_open_probes`` arrivals are admitted as probes; the first
    success closes it (failure ring reset), any failure re-trips it.
    """

    failure_threshold: int = 5
    window_s: float = 1.0
    cooldown_s: float = 1.0
    half_open_probes: int = 1

    def validate(self) -> None:
        if self.failure_threshold < 1:
            raise ValueError("circuit_breaker: failure_threshold must be >= 1")
        if self.window_s <= 0.0:
            raise ValueError("circuit_breaker: window_s must be > 0")
        if self.cooldown_s <= 0.0:
            raise ValueError("circuit_breaker: cooldown_s must be > 0")
        if self.half_open_probes < 1:
            raise ValueError("circuit_breaker: half_open_probes must be >= 1")


LOAD_SHED_POLICIES = ("queue_depth", "utilization")


@dataclass(frozen=True)
class LoadShedSpec:
    """Admission rejection at the server hop, before enqueue.

    ``policy="queue_depth"``: an arrival is shed when the server's queue
    already holds >= ``threshold`` jobs (a count). ``policy=
    "utilization"``: shed when the busy-slot fraction is >= ``threshold``
    (in (0, 1]; 1.0 sheds exactly when every slot is busy).
    ``priority_fraction`` of the traffic is exempt (a per-arrival
    Bernoulli on its own uniform slot). Shed jobs are terminal drops
    (``srv_shed_dropped``) and spawn no retries.
    """

    policy: str = "queue_depth"
    threshold: float = 1.0
    priority_fraction: float = 0.0

    def validate(self) -> None:
        if self.policy not in LOAD_SHED_POLICIES:
            raise ValueError(
                f"load_shed policy {self.policy!r} not in {LOAD_SHED_POLICIES}"
            )
        if self.policy == "queue_depth" and self.threshold < 1:
            raise ValueError(
                "load_shed: queue_depth threshold must be >= 1 (a job count)"
            )
        if self.policy == "utilization" and not 0.0 < self.threshold <= 1.0:
            raise ValueError(
                "load_shed: utilization threshold must be in (0, 1]"
            )
        if not 0.0 <= self.priority_fraction < 1.0:
            raise ValueError(
                "load_shed: priority_fraction must be in [0, 1) — 1.0 "
                "would exempt everything and the shed could never act"
            )


@dataclass(frozen=True)
class RetryBudgetSpec:
    """Token-bucket cap on the retry and hedge launch paths.

    Per-(replica, server) bucket: every first-attempt arrival credits
    ``ratio`` tokens and the bucket refills at ``min_per_s`` tokens/s
    (both capped at ``burst``); every retry launch (fault-rejection
    backoff retries, deadline retries, hedged second attempts) debits
    one token. A retry with no token is not launched: the job books its
    terminal outcome (fault drop or timeout) and the suppressed launch
    counts as ``srv_budget_dropped``, never a parked transit job.
    """

    ratio: float = 0.1
    min_per_s: float = 0.0
    burst: float = 10.0

    def validate(self) -> None:
        if self.ratio < 0.0:
            raise ValueError("retry_budget: ratio must be >= 0")
        if self.min_per_s < 0.0:
            raise ValueError("retry_budget: min_per_s must be >= 0")
        if self.ratio == 0.0 and self.min_per_s == 0.0:
            raise ValueError(
                "retry_budget: ratio and min_per_s are both 0 — the bucket "
                "would never refill and every retry after the initial burst "
                "would be suppressed; set at least one"
            )
        if self.burst < 1.0:
            raise ValueError(
                "retry_budget: burst must be >= 1 (a launch spends a whole "
                "token; a bucket that can never hold one suppresses all "
                "retries)"
            )


PARTITION_MODES = ("drop", "delay")


@dataclass(frozen=True)
class NetworkPartitionSpec:
    """A network cut isolating a GROUP of servers while a window is open:
    every delivery INTO a member is dropped (``mode="drop"``, counted in
    ``net_partitioned``) or parked in transit for ``delay_s`` more
    (``mode="delay"``). Windows are drawn as :class:`FaultSpec`'s are
    (gaps ~ Exp(``rate``), Exp or constant durations), each candidate
    kept with probability ``trigger_p`` (the whole group cuts together),
    or pinned by ``windows`` in every replica. ``group`` holds server
    indices; a server in several groups is cut under the OR, and drop
    wins over delay."""

    group: tuple[int, ...]
    rate: float = 0.0
    mean_duration_s: float = 0.0
    duration: str = "exponential"  # or "constant"
    trigger_p: float = 1.0
    max_windows: int = 4
    windows: Optional[tuple] = None  # ((start, end), ...) deterministic
    mode: str = "drop"  # or "delay"
    delay_s: float = 0.0

    def validate(self, label: str, n_servers: int) -> None:
        if not self.group:
            raise ValueError(f"{label}: partition group is empty")
        if len(set(self.group)) != len(self.group):
            raise ValueError(f"{label}: partition group repeats a server")
        for v in self.group:
            if not 0 <= v < n_servers:
                raise ValueError(f"{label}: group member {v} is not a server index")
        if self.mode not in PARTITION_MODES:
            raise ValueError(f"{label}: partition mode {self.mode!r} not in {PARTITION_MODES}")
        if self.mode == "delay" and self.delay_s <= 0.0:
            raise ValueError(f"{label}: mode='delay' requires delay_s > 0")
        if self.mode == "drop" and self.delay_s != 0.0:
            raise ValueError(
                f"{label}: delay_s requires mode='delay' (a dropped "
                "packet cannot also arrive late)"
            )
        if self.duration not in ("exponential", "constant"):
            raise ValueError(
                f"{label}: partition duration {self.duration!r} not in "
                "('exponential', 'constant')"
            )
        if not 0.0 < self.trigger_p <= 1.0:
            raise ValueError(f"{label}: trigger_p must be in (0, 1]")
        if self.max_windows < 1:
            raise ValueError(f"{label}: max_windows must be >= 1")
        if self.windows is not None:
            for start, end in self.windows:
                if start < 0.0 or end <= start:
                    raise ValueError(
                        f"{label}: partition window [{start}, {end}) is empty or negative"
                    )
        elif self.rate <= 0.0:
            raise ValueError(
                f"{label}: stochastic partition needs rate > 0 (or explicit windows=...)"
            )
        elif self.mean_duration_s <= 0.0:
            raise ValueError(f"{label}: partition needs mean_duration_s > 0")


@dataclass(frozen=True)
class QuorumSpec:
    """Quorum replication over a GROUP of servers: an arrival at a member
    is rejected (``server_quorum_dropped``, a retryable failure) while
    fewer than ``write`` members are reachable (drop-mode fault windows
    and partition windows take a member off the network), and that dark
    time is integrated (``quorum_dark_fraction``). ``write + read > n``
    is required for read-your-writes overlap."""

    group: tuple[int, ...]
    write: int
    read: int

    def validate(self, n_servers: int) -> None:
        if not self.group:
            raise ValueError("quorum: group is empty")
        if len(set(self.group)) != len(self.group):
            raise ValueError("quorum: group repeats a server")
        for v in self.group:
            if not 0 <= v < n_servers:
                raise ValueError(f"quorum: group member {v} is not a server")
        n = len(self.group)
        if not 1 <= self.write <= n:
            raise ValueError(f"quorum: write must be in [1, {n}], was {self.write}")
        if not 1 <= self.read <= n:
            raise ValueError(f"quorum: read must be in [1, {n}], was {self.read}")
        if self.write + self.read <= n:
            raise ValueError(
                f"quorum: write + read must exceed n for overlap "
                f"({self.write} + {self.read} <= {n})"
            )


ELECTION_STRATEGIES = ("bully", "phi_accrual")


def _erfcinv(y: float) -> float:
    """Inverse complementary error function by bisection (host side)."""
    lo, hi = 0.0, 40.0
    for _ in range(200):
        mid = (lo + hi) / 2.0
        if math.erfc(mid) > y:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


@dataclass(frozen=True)
class LeaderElectionSpec:
    """Leader election over a GROUP of servers: the highest-index
    reachable member leads; when the leader goes dark, the others elect
    again after the strategy's detection delay (:meth:`detection_delay_s`:
    ``timeout_s`` of silence for ``"bully"``; for ``"phi_accrual"`` the
    silence at which phi crosses ``phi_threshold`` over a steady heartbeat
    stream whose spread is the ``min_std_s`` floor). Reported as
    ``leader_changes``, ``time_without_leader_fraction`` and a windowed
    leader-uptime series."""

    group: tuple[int, ...]
    heartbeat_s: float
    timeout_s: float
    strategy: str = "bully"
    phi_threshold: float = 8.0
    min_std_s: float = 0.1

    def validate(self, n_servers: int) -> None:
        if not self.group:
            raise ValueError("leader_election: group is empty")
        if len(set(self.group)) != len(self.group):
            raise ValueError("leader_election: group repeats a server")
        for v in self.group:
            if not 0 <= v < n_servers:
                raise ValueError(f"leader_election: group member {v} is not a server")
        if self.heartbeat_s <= 0.0:
            raise ValueError("leader_election: heartbeat_s must be > 0")
        if self.strategy not in ELECTION_STRATEGIES:
            raise ValueError(
                f"leader_election strategy {self.strategy!r} not in {ELECTION_STRATEGIES}"
            )
        if self.strategy == "bully" and self.timeout_s < self.heartbeat_s:
            raise ValueError(
                "leader_election: timeout_s must be >= heartbeat_s (a "
                "timeout shorter than one heartbeat interval declares "
                "every live leader dead)"
            )
        if self.phi_threshold <= 0.0:
            raise ValueError("leader_election: phi_threshold must be > 0")
        if self.min_std_s <= 0.0:
            raise ValueError("leader_election: min_std_s must be > 0")

    def detection_delay_s(self) -> float:
        """Silence (seconds) after which the failure detector fires."""
        if self.strategy == "bully":
            return float(self.timeout_s)
        x = _erfcinv(2.0 * 10.0 ** (-self.phi_threshold))
        return float(self.heartbeat_s + self.min_std_s * math.sqrt(2.0) * x)


# The spec dataclasses keep the JAX package's field order and repr flags:
# engine.model_fingerprint hashes their repr, and a checkpoint of either
# package carries that digest.
@dataclass
class SourceSpec:
    rate: float
    arrival: str = "poisson"
    stop_after_s: Optional[float] = None
    downstream: Optional[NodeRef] = None
    profile: Optional[RateProfile] = None
    latency: EdgeLatency = field(default_factory=EdgeLatency)
    # A TraceSpec the source replays (arrival kind "trace"), else None;
    # out of the repr, which the fingerprint hashes: the trace enters it
    # through TraceSpec.signature().
    trace: Optional[TraceSpec] = field(default=None, repr=False)


@dataclass
class ServerSpec:
    concurrency: int = 1
    service_mean_s: float = 0.1
    service: str = "exponential"
    queue_capacity: int = 64
    downstream: Optional[NodeRef] = None
    latency: EdgeLatency = field(default_factory=EdgeLatency)
    # A completion whose sojourn exceeds deadline_s is a timeout; with
    # max_retries > 0 it is retried until the budget runs out.
    deadline_s: Optional[float] = None
    max_retries: int = 0
    service_k: int = 2  # erlang phases
    service_scv: float = 2.0  # hyperexp / lognormal squared cv
    pareto_alpha: float = 2.5  # pareto tail index
    # Brownout window [start, end): arrivals inside it are dropped.
    outage_start_s: Optional[float] = None
    outage_end_s: Optional[float] = None
    fault: Optional[FaultSpec] = None
    # retry_backoff_s turns every retry (deadline expiry and fault-window
    # rejection) into a re-arrival after backoff * 2^attempt, spread by
    # +/- retry_jitter/2; None keeps the immediate tail re-enqueue for
    # deadline retries and makes fault rejections terminal drops.
    retry_backoff_s: Optional[float] = None
    retry_jitter: float = 0.0
    # A hedged request launches a second attempt hedge_delay_s after the
    # first; the slot is held for min(S1, delay + S2).
    hedge_delay_s: Optional[float] = None


@dataclass
class RouterSpec:
    policy: str = "random"
    targets: list[NodeRef] = field(default_factory=list)
    target_latencies: list[EdgeLatency] = field(default_factory=list)
    # Per-target routing weights ("weighted" policy only): target i is
    # chosen with probability weights[i] / sum(weights); length-checked
    # against the final target list in validate().
    weights: tuple[float, ...] = field(default=(), repr=False)


@dataclass
class RemoteSpec:
    """Cross-partition egress point (partitioned execution only): jobs
    delivered here ride the outbox to the neighbour partition, arriving
    at its ``ingress`` server after ``latency_s``. The conservative-window
    contract requires ``latency_s >= window_s``."""

    latency_s: float = 0.01
    ingress: Optional[NodeRef] = None


@dataclass
class LimiterSpec:
    """Token bucket: ``refill_rate``/s up to ``capacity``; one token per
    job; jobs without a token are dropped (counted)."""

    refill_rate: float = 10.0
    capacity: float = 10.0
    downstream: Optional[NodeRef] = None
    latency: EdgeLatency = field(default_factory=EdgeLatency)


@dataclass
class SinkSpec:
    pass


class EnsembleModel:
    """Static topology of a service graph of sources, servers, routers,
    limiters and sinks.

    ``warmup_s`` masks statistics before the cutoff (sink latencies,
    server waits, utilization and queue-depth integrals); server
    started/completed/dropped counters stay whole-run.
    ``transit_capacity`` bounds the in-flight slots per server for jobs
    crossing latency-carrying edges. ``macro_block`` is the number of
    fused event steps per kernel launch and per RNG chunk (None = 32); it
    is part of the RNG stream layout.
    """

    def __init__(
        self,
        horizon_s: float = 60.0,
        warmup_s: float = 0.0,
        transit_capacity: int = 256,
        macro_block: Optional[int] = None,
    ):
        if warmup_s < 0.0 or warmup_s >= horizon_s:
            raise ValueError("warmup_s must satisfy 0 <= warmup_s < horizon_s")
        if transit_capacity < 1:
            raise ValueError("transit_capacity must be >= 1")
        if macro_block is not None and macro_block < 1:
            raise ValueError("macro_block must be >= 1 (or None for default)")
        self.horizon_s = horizon_s
        self.warmup_s = warmup_s
        self.transit_capacity = transit_capacity
        self.macro_block = macro_block
        self.sources: list[SourceSpec] = []
        self.servers: list[ServerSpec] = []
        self.routers: list[RouterSpec] = []
        self.limiters: list[LimiterSpec] = []
        self.sinks: list[SinkSpec] = []
        self.remotes: list[RemoteSpec] = []
        self.correlated_faults: Optional[CorrelatedOutages] = None
        # Windowed telemetry (telemetry.py); None builds the state and the
        # kernel arguments of a model without it.
        self.telemetry_spec: Optional[TelemetrySpec] = None
        # The resilience layer: each spec adds its per-(replica, server)
        # state leaves and gates; None leaves the model without them.
        self.circuit_breaker_spec: Optional[CircuitBreakerSpec] = None
        self.load_shed_spec: Optional[LoadShedSpec] = None
        self.retry_budget_spec: Optional[RetryBudgetSpec] = None
        # The consensus tier: partition groups, a quorum group and an
        # election group (none by default).
        self.network_partitions: list[NetworkPartitionSpec] = []
        self.quorum_spec: Optional[QuorumSpec] = None
        self.leader_election_spec: Optional[LeaderElectionSpec] = None

    # -- builders ----------------------------------------------------------
    def source(
        self,
        rate: float,
        kind: str = "poisson",
        stop_after_s: Optional[float] = None,
        profile: Optional[RateProfile] = None,
    ) -> NodeRef:
        if kind not in ARRIVAL_KINDS:
            raise ValueError(f"arrival kind {kind!r} not in {ARRIVAL_KINDS}")
        if profile is not None:
            profile.validate()
        self.sources.append(
            SourceSpec(rate=rate, arrival=kind, stop_after_s=stop_after_s, profile=profile)
        )
        return NodeRef(SOURCE, len(self.sources) - 1)

    def trace_arrivals(self, trace: TraceSpec, stop_after_s: Optional[float] = None) -> NodeRef:
        """A source replaying ``trace`` (a :class:`TraceSpec`): every
        replica fires the same instants, streamed to the device in pages.
        Its arrival kind is ``"trace"``: the trace is its only arrival
        authority (no rate, no profile), and it draws no gap.
        ``stop_after_s`` still ends the replay early."""
        if not isinstance(trace, TraceSpec):
            raise TypeError(
                f"trace_arrivals: expected a TraceSpec, got {type(trace).__name__}"
            )
        trace.validate()
        self.sources.append(
            SourceSpec(rate=0.0, arrival="trace", stop_after_s=stop_after_s, trace=trace)
        )
        return NodeRef(SOURCE, len(self.sources) - 1)

    def ramp_source(
        self,
        start_rate: float,
        end_rate: float,
        ramp_duration_s: float,
        kind: str = "poisson",
    ) -> NodeRef:
        """Arrival rate climbing linearly start->end over the ramp window."""
        return self.source(
            rate=start_rate,
            kind=kind,
            profile=RateProfile(
                kind="ramp", end_rate=end_rate, ramp_duration_s=ramp_duration_s
            ),
        )

    def spike_source(
        self,
        base_rate: float,
        spike_rate: float,
        spike_start_s: float,
        spike_end_s: float,
        kind: str = "poisson",
    ) -> NodeRef:
        """Constant base rate with a burst window at ``spike_rate``."""
        return self.source(
            rate=base_rate,
            kind=kind,
            profile=RateProfile(
                kind="spike",
                spike_rate=spike_rate,
                spike_start_s=spike_start_s,
                spike_end_s=spike_end_s,
            ),
        )

    def server(
        self,
        concurrency: int = 1,
        service_mean: float = 0.1,
        service: str = "exponential",
        queue_capacity: int = 64,
        deadline_s: Optional[float] = None,
        max_retries: int = 0,
        service_k: int = 2,
        service_scv: float = 2.0,
        pareto_alpha: float = 2.5,
        outage: Optional[tuple] = None,
        fault: Optional[FaultSpec] = None,
        retry_backoff_s: Optional[float] = None,
        retry_jitter: float = 0.0,
        hedge_delay_s: Optional[float] = None,
    ) -> NodeRef:
        if service not in SERVICE_KINDS:
            raise ValueError(f"service kind {service!r} not in {SERVICE_KINDS}")
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        label = f"server[{len(self.servers)}]"
        fault_can_retry = (
            fault is not None
            and fault.mode == "outage"
            and retry_backoff_s is not None
        )
        if (
            max_retries > 0
            and deadline_s is None
            and not fault_can_retry
            and retry_backoff_s is None
        ):
            raise ValueError(
                "max_retries requires a deadline_s (timeout retries) or "
                "retry_backoff_s plus a rejection source (an outage-mode "
                "fault or quorum membership)"
            )
        if fault is not None:
            fault.validate(label)
        if retry_backoff_s is not None:
            if retry_backoff_s <= 0:
                raise ValueError("retry_backoff_s must be > 0")
            if max_retries < 1:
                raise ValueError("retry_backoff_s requires max_retries >= 1")
        if not 0.0 <= retry_jitter <= 1.0:
            raise ValueError("retry_jitter must be in [0, 1]")
        if retry_jitter > 0.0 and retry_backoff_s is None:
            raise ValueError("retry_jitter requires retry_backoff_s")
        if hedge_delay_s is not None and hedge_delay_s <= 0:
            raise ValueError("hedge_delay_s must be > 0")
        if service == "erlang" and service_k not in (2, 3):
            raise ValueError("erlang supports service_k in (2, 3)")
        if service in ("hyperexp", "lognormal") and service_scv <= (
            1.0 if service == "hyperexp" else 0.0
        ):
            raise ValueError(
                "service_scv must be > 1 for hyperexp and > 0 for lognormal"
            )
        if service == "pareto" and pareto_alpha <= 1.0:
            raise ValueError("pareto_alpha must be > 1 (finite mean)")
        if outage is not None:
            start, end = outage
            if start < 0.0:
                raise ValueError(f"outage window start must be >= 0, was {start}")
            if end <= start:
                raise ValueError(f"outage window is empty: [{start}, {end})")
        self.servers.append(
            ServerSpec(
                concurrency=concurrency,
                service_mean_s=service_mean,
                service=service,
                queue_capacity=queue_capacity,
                service_k=service_k,
                service_scv=service_scv,
                pareto_alpha=pareto_alpha,
                deadline_s=deadline_s,
                max_retries=max_retries,
                outage_start_s=outage[0] if outage is not None else None,
                outage_end_s=outage[1] if outage is not None else None,
                fault=fault,
                retry_backoff_s=retry_backoff_s,
                retry_jitter=retry_jitter,
                hedge_delay_s=hedge_delay_s,
            )
        )
        return NodeRef(SERVER, len(self.servers) - 1)

    def correlated_outages(
        self,
        rate: float,
        mean_duration_s: float,
        trigger_p: float = 1.0,
        max_windows: int = 4,
    ) -> CorrelatedOutages:
        """Install the shared Bernoulli-trigger outage schedule. Servers
        opt in with ``fault=FaultSpec(correlated=True, ...)``; during a
        fired window every subscribed server applies its own fault
        ``mode`` at once."""
        spec = CorrelatedOutages(
            rate=rate,
            mean_duration_s=mean_duration_s,
            trigger_p=trigger_p,
            max_windows=max_windows,
        )
        spec.validate()
        self.correlated_faults = spec
        return spec

    def router(
        self,
        policy: str = "random",
        targets: Sequence[NodeRef] = (),
        weights: Optional[Sequence[float]] = None,
    ) -> NodeRef:
        """Routing node. ``weights`` (``"weighted"`` policy only) gives
        each target probability ``w_i / sum(w)``; targets wired later via
        :meth:`connect` must match the weights' length at validate()."""
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"router policy {policy!r} not in {ROUTER_POLICIES}")
        if weights is not None and policy != "weighted":
            raise ValueError(
                f"router weights require policy='weighted' (got {policy!r})"
            )
        if policy == "weighted":
            if not weights:
                raise ValueError("policy='weighted' requires weights=(...)")
            if any(w <= 0.0 for w in weights):
                raise ValueError("router weights must all be > 0")
        targets = list(targets)
        self.routers.append(
            RouterSpec(
                policy=policy,
                targets=targets,
                target_latencies=[EdgeLatency() for _ in targets],
                weights=tuple(float(w) for w in weights) if weights else (),
            )
        )
        return NodeRef(ROUTER, len(self.routers) - 1)

    def limiter(self, refill_rate: float, capacity: float) -> NodeRef:
        """Token-bucket admission node (jobs without a token are dropped)."""
        if refill_rate <= 0:
            raise ValueError("refill_rate must be > 0")
        if capacity < 1:
            # Admission spends a whole token; a bucket that can never hold
            # one would silently drop all traffic.
            raise ValueError("capacity must be >= 1")
        self.limiters.append(LimiterSpec(refill_rate=refill_rate, capacity=capacity))
        return NodeRef(LIMITER, len(self.limiters) - 1)

    def sink(self) -> NodeRef:
        self.sinks.append(SinkSpec())
        return NodeRef(SINK, len(self.sinks) - 1)

    def telemetry(
        self,
        window_s: float,
        metrics: Sequence[str] = DEFAULT_METRICS,
    ) -> TelemetrySpec:
        """Enable windowed telemetry (telemetry.py): the event step adds
        into per-replica ``(n_windows, ...)`` buffers at its accounting
        sites, which yields per-window throughput, latency percentiles,
        queue and utilization integrals, drop/retry/loss counts, the
        cross-replica spread and fault-window occupancy as
        :attr:`EnsembleResult.timeseries`. ``window_s`` must tile the
        horizon into 2 to 4096 windows. Telemetry draws no uniform, so
        the simulation is the same as without it."""
        spec = TelemetrySpec(window_s=float(window_s), metrics=tuple(metrics))
        spec.validate(self.horizon_s)
        self.telemetry_spec = spec
        return spec

    def circuit_breaker(
        self,
        failure_threshold: int = 5,
        window_s: float = 1.0,
        cooldown_s: float = 1.0,
        half_open_probes: int = 1,
    ) -> CircuitBreakerSpec:
        """Give every server of every replica its own closed -> open ->
        half-open breaker, driven by the fault and timeout accounting
        sites: ``failure_threshold`` failures inside a sliding
        ``window_s`` trip it, arrivals while open are rejected outright
        (``srv_breaker_dropped``), and after ``cooldown_s`` up to
        ``half_open_probes`` probe arrivals decide whether it re-closes
        (first success) or re-trips (any failure). :meth:`validate`
        requires a failure site somewhere in the model (a deadline, an
        outage-mode fault or a brownout window)."""
        spec = CircuitBreakerSpec(
            failure_threshold=failure_threshold,
            window_s=window_s,
            cooldown_s=cooldown_s,
            half_open_probes=half_open_probes,
        )
        spec.validate()
        self.circuit_breaker_spec = spec
        return spec

    def load_shed(
        self,
        policy: str = "queue_depth",
        threshold: float = 1.0,
        priority_fraction: float = 0.0,
    ) -> LoadShedSpec:
        """Shed arrivals at every server before enqueue when the policy's
        signal is at or past ``threshold`` (``"queue_depth"``: a job
        count; ``"utilization"``: the busy-slot fraction in (0, 1]);
        ``priority_fraction`` of the traffic is exempt. Shed jobs are
        terminal ``srv_shed_dropped`` drops."""
        spec = LoadShedSpec(
            policy=policy, threshold=threshold, priority_fraction=priority_fraction
        )
        spec.validate()
        self.load_shed_spec = spec
        return spec

    def retry_budget(
        self,
        ratio: float = 0.1,
        min_per_s: float = 0.0,
        burst: float = 10.0,
    ) -> RetryBudgetSpec:
        """Cap every retry and hedge launch with a per-(replica, server)
        token bucket: a launch debits one token, first-attempt arrivals
        credit ``ratio`` tokens and the bucket refills at ``min_per_s``
        tokens/s (capped at ``burst``). A launch without a token is
        suppressed and counted as ``srv_budget_dropped``; the job's
        terminal outcome books as usual. :meth:`validate` requires a
        consumer (a server with ``max_retries > 0`` or a hedge delay)."""
        spec = RetryBudgetSpec(ratio=ratio, min_per_s=min_per_s, burst=burst)
        spec.validate()
        self.retry_budget_spec = spec
        return spec

    def network_partition(
        self,
        group: Sequence[NodeRef],
        rate: float = 0.0,
        mean_duration_s: float = 0.0,
        duration: str = "exponential",
        trigger_p: float = 1.0,
        max_windows: int = 4,
        windows: Optional[tuple] = None,
        mode: str = "drop",
        delay_s: float = 0.0,
    ) -> NetworkPartitionSpec:
        """Declare a partition group over ``group`` servers: while one of
        its windows is open, deliveries INTO a member are dropped
        (``mode="drop"``) or parked ``delay_s`` more in transit
        (``mode="delay"``). Call again for further independent cuts."""
        for ref in group:
            if ref.kind != SERVER:
                raise ValueError("network_partition group members must be servers")
        spec = NetworkPartitionSpec(
            group=tuple(ref.index for ref in group),
            rate=rate,
            mean_duration_s=mean_duration_s,
            duration=duration,
            trigger_p=trigger_p,
            max_windows=max_windows,
            windows=windows,
            mode=mode,
            delay_s=delay_s,
        )
        spec.validate(f"network_partition[{len(self.network_partitions)}]", len(self.servers))
        self.network_partitions.append(spec)
        return spec

    def quorum(self, group: Sequence[NodeRef], write: int, read: int) -> QuorumSpec:
        """Declare quorum replication over ``group`` servers; :meth:`validate`
        requires a dark source (an outage-mode fault or a partition group)
        touching a member."""
        for ref in group:
            if ref.kind != SERVER:
                raise ValueError("quorum group members must be servers")
        spec = QuorumSpec(group=tuple(ref.index for ref in group), write=write, read=read)
        spec.validate(len(self.servers))
        self.quorum_spec = spec
        return spec

    def leader_election(
        self,
        group: Sequence[NodeRef],
        heartbeat_s: float,
        timeout_s: float,
        strategy: str = "bully",
        phi_threshold: float = 8.0,
        min_std_s: float = 0.1,
    ) -> LeaderElectionSpec:
        """Declare leader election over ``group`` servers; :meth:`validate`
        requires a dark source touching a member."""
        for ref in group:
            if ref.kind != SERVER:
                raise ValueError("leader_election group members must be servers")
        spec = LeaderElectionSpec(
            group=tuple(ref.index for ref in group),
            heartbeat_s=heartbeat_s,
            timeout_s=timeout_s,
            strategy=strategy,
            phi_threshold=phi_threshold,
            min_std_s=min_std_s,
        )
        spec.validate(len(self.servers))
        self.leader_election_spec = spec
        return spec

    def remote(self, ingress: NodeRef, latency_s: float) -> NodeRef:
        """Cross-partition egress: jobs exit here and arrive at the
        NEIGHBOR partition's ``ingress`` server after ``latency_s``
        (partitioned execution only)."""
        if ingress.kind != SERVER:
            raise ValueError("remote ingress must be a server")
        if latency_s <= 0:
            raise ValueError("remote latency_s must be > 0 (window contract)")
        self.remotes.append(RemoteSpec(latency_s=latency_s, ingress=ingress))
        return NodeRef(REMOTE, len(self.remotes) - 1)

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
        """Wire ``origin`` -> ``downstream``; the edge may carry latency
        (``latency_kind`` "constant" or "exponential", mean
        ``latency_s``). ``loss_p`` drops each crossing with that
        probability while ``loss_window`` (a ``(start_s, end_s)`` pair;
        default: the whole run) is open. Edges INTO a limiter or a router
        must be latency- and loss-free: put the latency or loss on the
        limiter's downstream edge or on the router's per-target edges
        (one lossy edge per delivery hop, so each crossing spends exactly
        one Bernoulli draw). A router origin appends a target."""
        if latency_s < 0:
            raise ValueError("latency_s must be >= 0")
        if latency_kind not in LATENCY_KINDS:
            raise ValueError(f"latency kind {latency_kind!r} not in {LATENCY_KINDS}")
        if not 0.0 <= loss_p < 1.0:
            raise ValueError("loss_p must be in [0, 1)")
        if loss_window is not None:
            if loss_p == 0.0:
                raise ValueError("loss_window requires loss_p > 0")
            if loss_window[1] <= loss_window[0]:
                raise ValueError(f"loss_window is empty: {loss_window}")
        if downstream.kind == LIMITER and (latency_s > 0 or loss_p > 0):
            raise ValueError(
                "edges into a limiter must be latency- and loss-free; put "
                "the latency/loss on the limiter's downstream edge"
            )
        if downstream.kind == ROUTER and (latency_s > 0 or loss_p > 0):
            raise ValueError(
                "edges into a router must be latency- and loss-free; put "
                "the latency/loss on the router's per-target edges instead"
            )
        if downstream.kind == REMOTE and (latency_s > 0 or loss_p > 0):
            raise ValueError(
                "edges into a remote are latency- and loss-free; the remote "
                "itself carries the cross-partition latency"
            )
        edge = EdgeLatency(
            mean_s=latency_s,
            kind=latency_kind,
            loss_p=loss_p,
            loss_start_s=loss_window[0] if loss_window else 0.0,
            loss_end_s=loss_window[1] if loss_window else float("inf"),
        )
        if origin.kind == SOURCE:
            self.sources[origin.index].downstream = downstream
            self.sources[origin.index].latency = edge
        elif origin.kind == SERVER:
            self.servers[origin.index].downstream = downstream
            self.servers[origin.index].latency = edge
        elif origin.kind == LIMITER:
            if downstream.kind == LIMITER:
                raise ValueError("Limiters cannot chain to limiters")
            self.limiters[origin.index].downstream = downstream
            self.limiters[origin.index].latency = edge
        elif origin.kind == ROUTER:
            # Router->router edges are legal (multi-tier DAGs); validate()
            # rejects router cycles.
            self.routers[origin.index].targets.append(downstream)
            self.routers[origin.index].target_latencies.append(edge)
        elif origin.kind == REMOTE:
            raise ValueError(
                "a remote's destination is fixed: jobs arrive at its "
                "ingress server on the neighbor partition"
            )
        else:
            raise ValueError("Sinks have no downstream")

    # -- validation --------------------------------------------------------
    def validate(self, allow_remote: bool = False) -> None:
        """Check the model against JAX's validation rules for the model API
        above (JAX's ``EnsembleModel.validate``); remote egress nodes only
        with ``allow_remote`` (a partitioned run)."""
        if not self.sources:
            raise ValueError("Model needs at least one source")
        if not self.sinks:
            raise ValueError("Model needs at least one sink")
        if self.remotes and not allow_remote:
            raise ValueError(
                "model has remote() egress nodes — use run_partitioned, "
                "not run_ensemble"
            )
        for i, remote in enumerate(self.remotes):
            if remote.ingress is None or remote.ingress.kind != SERVER:
                raise ValueError(f"remote[{i}] needs a server ingress")
        traced = [i for i, s in enumerate(self.sources) if s.trace is not None]
        if len(traced) > 1:
            raise ValueError(
                f"trace_arrivals: at most one traced source per model "
                f"(sources {traced} all carry traces) — merge the streams "
                "into one TraceSpec with tenant ids"
            )
        for i, source in enumerate(self.sources):
            if source.downstream is None:
                raise ValueError(f"source[{i}] has no downstream")
            if source.downstream.kind == ROUTER and not self.routers[
                source.downstream.index
            ].targets:
                raise ValueError(f"router targeted by source[{i}] has no targets")
            if source.trace is not None:
                if source.profile is not None:
                    raise ValueError(
                        f"source[{i}]: profile (kind "
                        f"{source.profile.kind!r}) and trace_arrivals "
                        f"({source.trace!r}) on the same source — one "
                        "arrival authority per source; drop one of them"
                    )
                if source.arrival != "trace":
                    raise ValueError(
                        f"source[{i}]: carries a trace but arrival kind is "
                        f"{source.arrival!r} — build traced sources via "
                        "model.trace_arrivals(...)"
                    )
                source.trace.validate()
            elif source.arrival == "trace":
                raise ValueError(
                    f"source[{i}]: arrival kind 'trace' without a TraceSpec "
                    "— build traced sources via model.trace_arrivals(...)"
                )
            elif source.arrival not in ARRIVAL_KINDS:
                raise ValueError(f"source[{i}]: arrival kind {source.arrival!r}")
        if self.correlated_faults is not None:
            self.correlated_faults.validate()
        if self.telemetry_spec is not None:
            self.telemetry_spec.validate(self.horizon_s)
        self._validate_resilience()
        self._validate_consensus()
        quorum_members = set(self.quorum_spec.group) if self.quorum_spec is not None else set()
        for i, server in enumerate(self.servers):
            if server.downstream is None:
                raise ValueError(f"server[{i}] has no downstream")
            if server.service not in SERVICE_KINDS:
                raise ValueError(f"server[{i}]: service kind {server.service!r}")
            if (
                server.max_retries > 0
                and server.deadline_s is None
                and not (
                    server.fault is not None
                    and server.fault.mode == "outage"
                    and server.retry_backoff_s is not None
                )
                and i not in quorum_members
            ):
                # The server()-time check deferred because a backoff was
                # given; without a rejection source (a fault or quorum
                # membership) the retry path is dead.
                raise ValueError(
                    f"server[{i}]: max_retries requires a deadline_s "
                    "(timeout retries) or retry_backoff_s plus a rejection "
                    "source (an outage-mode fault or quorum membership)"
                )
            if server.fault is not None:
                server.fault.validate(f"server[{i}]")
                if server.fault.correlated and self.correlated_faults is None:
                    raise ValueError(
                        f"server[{i}]: fault.correlated=True but the model "
                        "has no correlated_outages() schedule"
                    )
            if server.downstream.kind == ROUTER and not self.routers[
                server.downstream.index
            ].targets:
                raise ValueError(f"router targeted by server[{i}] has no targets")
        for i, limiter in enumerate(self.limiters):
            if limiter.downstream is None:
                raise ValueError(f"limiter[{i}] has no downstream")
            if limiter.downstream.kind == LIMITER:
                raise ValueError(f"limiter[{i}] chains to a limiter")
        for i, router in enumerate(self.routers):
            self._validate_router(i, router, allow_remote)
        self._validate_router_acyclic()

    def _validate_resilience(self) -> None:
        """JAX's resilience clauses: a breaker needs a failure site (a
        degrade-mode fault rejects nothing, so it is not one), shedding
        needs a server, a budget needs a retry or hedge path."""
        if self.circuit_breaker_spec is not None:
            self.circuit_breaker_spec.validate()
            has_failure_site = any(
                s.deadline_s is not None
                or (s.fault is not None and s.fault.mode == "outage")
                or s.outage_start_s is not None
                for s in self.servers
            ) or self.quorum_spec is not None
            if not has_failure_site:
                raise ValueError(
                    "circuit_breaker: no server declares a failure site "
                    "(deadline_s, an outage-mode fault, or outage=...) — "
                    "the breaker could never observe a failure and would "
                    "never trip"
                )
        if self.load_shed_spec is not None:
            self.load_shed_spec.validate()
            if not self.servers:
                raise ValueError("load_shed: the model has no servers to shed at")
        if self.retry_budget_spec is not None:
            self.retry_budget_spec.validate()
            has_consumer = any(
                s.max_retries > 0 or s.hedge_delay_s is not None for s in self.servers
            )
            if not has_consumer:
                raise ValueError(
                    "retry_budget: no server declares a retry or hedge path "
                    "(max_retries > 0 or hedge_delay_s) — the budget would "
                    "gate nothing"
                )

    def _validate_consensus(self) -> None:
        """JAX's consensus clauses: each spec's own checks, and a quorum or
        an election group needs a member that can go dark."""
        for i, partition in enumerate(self.network_partitions):
            partition.validate(f"network_partition[{i}]", len(self.servers))
        if self.quorum_spec is not None:
            self.quorum_spec.validate(len(self.servers))
            if not self._has_dark_source(self.quorum_spec.group):
                raise ValueError(
                    "quorum: no group member has a dark source (an "
                    "outage-mode fault schedule or a network partition "
                    "touching it) — the quorum could never lose a member"
                )
        if self.leader_election_spec is not None:
            self.leader_election_spec.validate(len(self.servers))
            if not self._has_dark_source(self.leader_election_spec.group):
                raise ValueError(
                    "leader_election: no group member has a dark source "
                    "(an outage-mode fault schedule or a network "
                    "partition touching it) — the leader could never fail"
                )

    def _has_dark_source(self, group: tuple[int, ...]) -> bool:
        """Whether any ``group`` member can become unreachable: an
        outage-mode fault schedule (a degraded server still answers) or
        a partition group covering it."""
        partitioned = {v for p in self.network_partitions for v in p.group}
        return any(
            (self.servers[v].fault is not None and self.servers[v].fault.mode == "outage")
            or v in partitioned
            for v in group
        )

    def _validate_router(self, i: int, router: RouterSpec, allow_remote: bool = False) -> None:
        kinds = {t.kind for t in router.targets}
        if LIMITER in kinds:
            raise ValueError(
                f"router[{i}] targets a limiter (route after, not into, admission)"
            )
        if REMOTE in kinds and not allow_remote:
            raise ValueError(f"router[{i}] targets a remote — partitioned mode only")
        # Server/sink sets (including "done or continue" mixes),
        # downstream routers (multi-tier DAGs) and (partitioned)
        # sink+remote mixes, "stay local or hop to the neighbor"; a
        # router+sink mix races a zero-work exit against a routing tier
        # and is rejected.
        if not (kinds <= {SERVER, SINK, ROUTER} or (allow_remote and kinds <= {SINK, REMOTE})):
            raise ValueError(
                f"router[{i}] targets must be servers, sinks, and/or "
                "downstream routers, or (partitioned) sinks+remotes"
            )
        if ROUTER in kinds and SINK in kinds:
            raise ValueError(
                f"router[{i}] mixes a downstream router with a sink "
                "target — a done-or-continue exit belongs on the "
                "downstream router's target list, not raced against it"
            )
        if kinds == {SERVER, SINK} and router.policy == "least_outstanding":
            raise ValueError(
                f"router[{i}]: least_outstanding needs all-server "
                "targets (sinks have no outstanding work)"
            )
        if REMOTE in kinds and router.policy != "random":
            raise ValueError(f"router[{i}]: remote targets require the 'random' policy")
        if router.policy == "least_outstanding" and kinds - {SERVER}:
            raise ValueError(
                f"router[{i}]: least_outstanding requires server targets "
                "(only servers carry outstanding work)"
            )
        if router.policy == "weighted" and len(router.weights) != len(router.targets):
            raise ValueError(
                f"router[{i}]: weighted policy has {len(router.weights)} "
                f"weights for {len(router.targets)} targets (wire every "
                "target before running, or pass targets to router())"
            )

    def _validate_router_acyclic(self) -> None:
        """Reject router cycles through DIRECT router->router targets (the
        delivery walk would never end). Cycles THROUGH a server are fine:
        a server arrival ends the delivery."""
        # state: 0 unvisited, 1 on the current DFS path, 2 done.
        state = [0] * len(self.routers)

        def visit(i: int, path: list[int]) -> None:
            if state[i] == 1:
                start = path.index(i)
                cycle = " -> ".join(f"router[{j}]" for j in path[start:] + [i])
                raise ValueError(
                    f"router[{i}] is on a router cycle ({cycle}) — route "
                    "feedback through a server, not directly between "
                    "routers"
                )
            if state[i] == 2:
                return
            state[i] = 1
            path.append(i)
            for target in self.routers[i].targets:
                if target.kind == ROUTER:
                    visit(target.index, path)
            path.pop()
            state[i] = 2

        for i in range(len(self.routers)):
            if state[i] == 0:
                visit(i, [])

    def iter_edges(self):
        """Every edge spec in the model: source, server and limiter
        downstream edges, then each router's per-target edges."""
        for s in self.sources:
            yield s.latency
        for v in self.servers:
            yield v.latency
        for lim in self.limiters:
            yield lim.latency
        for r in self.routers:
            yield from r.target_latencies

    def chaos_features(self) -> tuple[str, ...]:
        """The chaos features this model declares, by JAX's stable names
        (``EnsembleModel.chaos_features``); the kernel plan records them
        under ``"chaos"``."""
        features: list[str] = []
        if any(s.fault is not None for s in self.servers):
            features.append("faults")
        if self.correlated_faults is not None:
            features.append("correlated_outages")
        if any(s.retry_backoff_s is not None for s in self.servers):
            features.append("backoff_retries")
        if any(s.hedge_delay_s is not None for s in self.servers):
            features.append("hedging")
        if any(s.outage_start_s is not None for s in self.servers):
            features.append("brownouts")
        if any(e.loss_p > 0.0 for e in self.iter_edges()):
            features.append("packet_loss")
        if self.limiters:
            features.append("limiters")
        features.extend(self.resilience_features())
        features.extend(self.consensus_features())
        if self.telemetry_spec is not None:
            features.append("telemetry")
        if self.traced_source_index() is not None:
            features.append("trace_arrivals")
        return tuple(features)

    def traced_source_index(self) -> Optional[int]:
        """The index of the traced source (at most one: validate), or
        None for a model without a trace."""
        for i, source in enumerate(self.sources):
            if source.trace is not None:
                return i
        return None

    def kernel_supported(self) -> tuple[bool, str]:
        """Whether the CUDA event-step kernel runs this model: ``(True,
        "")`` when every fixed bound of the kernel holds
        (:func:`~happysim_tpu_torch.kernels.support.check_kernel_bounds`),
        else ``(False, the bound's message)``. The port runs every model
        ``validate`` accepts on the kernel, so the bounds are its only
        refusal; a refused model still runs with ``device="cpu"``."""
        from happysim_tpu_torch.engine import _Compiled
        from happysim_tpu_torch.kernels import support

        compiled = _Compiled(self)
        try:
            support.check_kernel_bounds(compiled, compiled.macro)
        except ValueError as exc:
            return False, str(exc)
        return True, ""

    def consensus_features(self) -> tuple[str, ...]:
        """The consensus features this model declares, by JAX's names (a
        subset of :meth:`chaos_features`)."""
        features: list[str] = []
        if self.network_partitions:
            features.append("network_partitions")
        if self.quorum_spec is not None:
            features.append("quorum")
        if self.leader_election_spec is not None:
            features.append("leader_election")
        return tuple(features)

    def resilience_features(self) -> tuple[str, ...]:
        """The resilience defenses this model declares, by JAX's names (a
        subset of :meth:`chaos_features`)."""
        features: list[str] = []
        if self.circuit_breaker_spec is not None:
            features.append("circuit_breaker")
        if self.load_shed_spec is not None:
            features.append("load_shed")
        if self.retry_budget_spec is not None:
            features.append("retry_budget")
        return tuple(features)

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
